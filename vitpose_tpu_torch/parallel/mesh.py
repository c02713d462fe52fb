"""The layout of processes over the data, expert and model axes, and the
collectives that training runs over them.

Counterpart of vitpose_tpu/parallel/mesh.py. JAX lays a `Mesh` over its
devices and lets XLA insert the collectives; here one process drives one
card, `make_mesh` arranges the processes of the default group as
(data, expert, model), rank = (d * n_expert + e) * n_model + m as JAX
reshapes its devices, and builds one process group per axis. The
collectives are torch.distributed calls (NCCL on the card, gloo on the
CPU), written where XLA would insert them:

  * ``data``: the global batch's rows r, r + n, r + 2n, ... go to data rank
    r (`shard_rows`; the top-down loader's process shard gives the same
    split). Each rank's loss is a mean over its rows, and
    `reduce_gradients` averages the gradients over the data group, which
    is the gradient of the global batch's mean loss. BatchNorm's batch
    statistics (`models/heads.batch_norm`) and the counts of the
    count-normalised losses are summed over the group by `data_sum`, an
    autograd function whose backward sums too, so they are the global
    batch's. Random masks (DropPath, dropout) are drawn for the global batch
    and each rank keeps its rows (`draw_rows`).
  * ``expert`` and ``model``: the ViTPose+ experts and the FFN products are
    split over them (`shard_params`, Megatron's tensor parallelism: fc1 on
    its output, fc2 and the experts' hidden dimension on their input, one
    all-reduce after the product), and the ranks of one such group see the
    same rows. `copy_to_group` and `reduce_from_group` are Megatron's f and
    g: identity forward and all-reduce backward, and the reverse.

`activate(layout)` makes a layout the one these functions read; without
one, or on an axis without a group (make_mesh builds none for an axis of
size 1), every function here is the identity and nothing is
communicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import group_timeout, rank_and_world

AXES = ('data', 'expert', 'model')

# gradients are all-reduced in flat buckets of at most this many elements
BUCKET_ELEMENTS = 1 << 24


@dataclasses.dataclass
class Layout:
    """The (data, expert, model) coordinates of this process and the
    process group of each axis (None for an axis of size 1)."""
    n_data: int = 1
    n_expert: int = 1
    n_model: int = 1
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)

    def size(self, axis):
        return getattr(self, f'n_{axis}')

    def index(self, axis):
        """This process's coordinate on `axis`."""
        m = self.rank % self.n_model
        e = self.rank // self.n_model % self.n_expert
        d = self.rank // (self.n_model * self.n_expert)
        return {'data': d, 'expert': e, 'model': m}[axis]

    def group(self, axis):
        return self.groups.get(axis)


def make_mesh(n_data: Optional[int] = None, n_expert: int = 1,
              n_model: int = 1) -> Layout:
    """The (data, expert, model) layout of the default process group
    (JAX `make_mesh`): n_data defaults to the world size over
    n_expert * n_model, and axes that do not factor the world size raise
    ValueError. Every process must call it, in the same order as any other
    group-building call: it builds one process group per axis of size > 1
    (and a gloo one for host flags), each with the default group's limit
    on a collective.
    """
    rank, world = rank_and_world()
    timeout = group_timeout()
    if n_data is None:
        n_data = world // (n_expert * n_model)
    if n_data * n_expert * n_model != world:
        raise ValueError(
            f'mesh axes data={n_data} x expert={n_expert} x '
            f'model={n_model} must factor the process count {world}')
    layout = Layout(n_data, n_expert, n_model, rank)
    if world > 1:
        # host flags (a preemption) go over gloo, which reads no card
        layout.groups['control'] = dist.new_group(backend='gloo',
                                                  timeout=timeout)
    coords = np.arange(world).reshape(n_data, n_expert, n_model)
    for ax, axis in enumerate(AXES):
        if coords.shape[ax] == 1:
            continue
        # the ranks that differ only on `axis`, one group per line
        lines = np.moveaxis(coords, ax, -1).reshape(-1, coords.shape[ax])
        for line in lines:
            group = dist.new_group([int(r) for r in line], timeout=timeout)
            if rank in line:
                layout.groups[axis] = group
    return layout


_ACTIVE: Optional[Layout] = None


@contextlib.contextmanager
def activate(layout: Optional[Layout]):
    """Make `layout` the one the collectives of this module (and the
    models' BatchNorm, DropPath and sharded FFNs) read, for the block."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, layout
    try:
        yield layout
    finally:
        _ACTIVE = before


def axis_group(axis):
    """(group, size, index) of `axis` in the active layout; (None, 1, 0)
    without one or where the axis has no group (make_mesh builds none for
    an axis of size 1; a Layout made by hand may give one a group of one
    process, whose collectives then run, as a check of the path)."""
    layout = _ACTIVE
    if layout is None or layout.group(axis) is None:
        return None, 1, 0
    return layout.group(axis), layout.size(axis), layout.index(axis)


def any_process(flag: bool) -> bool:
    """Whether `flag` is true on any process of the active layout (a host
    all-reduce over its gloo control group; `flag` itself alone)."""
    layout = _ACTIVE
    if layout is None or layout.group('control') is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, group=layout.group('control'))
    return bool(t.item())


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the gradients over it too (each
    rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x, group):
    """Autograd-aware sum of `x` over `group` (identity where None)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_group(x, group):
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if group is None else _ReduceFromGroup.apply(x, group)


def data_sum(x):
    """`x` summed over the active data group, gradients included."""
    return all_reduce_sum(x, axis_group('data')[0])


def global_batch_mean(x):
    """The mean over dim 0 of the global batch whose rows are split
    evenly over the data group (the local mean where there is none)."""
    group, n, _ = axis_group('data')
    if group is None:
        return x.mean(0)
    return all_reduce_sum(x.sum(0), group) / (x.shape[0] * n)


def shard_rows(batch):
    """This data rank's rows r, r + n, ... of a global batch: of a tensor
    or a numpy array on dim 0, of a list (one item a row), and of each
    member of a dict or a tuple alike; the batch itself without a data
    axis."""
    _, n, r = axis_group('data')
    if n == 1:
        return batch

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(cut(v) for v in x)
        if isinstance(x, (torch.Tensor, np.ndarray, list)) and (
                len(x) if isinstance(x, list) else x.ndim):
            if len(x) % n:
                raise ValueError(f'a batch of {len(x)} rows does not '
                                 f'split over {n} data ranks')
            return x[r::n]
        return x
    return cut(batch)


def draw_rows(draw, shape):
    """`draw(shape)` for this rank's rows of the global batch: the global
    batch's draw (dim 0 times the data axis) from the same generator on
    every rank, of which each keeps its rows, so that n ranks draw what
    one process does over the whole batch."""
    _, n, r = axis_group('data')
    if n == 1:
        return draw(shape)
    return draw((shape[0] * n,) + tuple(shape[1:]))[r::n]


def _buckets(tensors):
    """Consecutive runs of `tensors` of one dtype and device, each of at
    most BUCKET_ELEMENTS elements (or one larger tensor)."""
    run, size = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + t.numel() > BUCKET_ELEMENTS):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


def reduce_gradients(params):
    """Average the `.grad` of `params` over the active data group, in flat
    buckets, in the order given (which must be every rank's). Every
    parameter must have a gradient; a no-op without a data axis."""
    group, n, _ = axis_group('data')
    if group is None:
        return
    grads = [p.grad for p in params]
    if any(g is None for g in grads):
        raise ValueError('reduce_gradients: a parameter has no gradient; '
                         'give it zeros first, as every rank must reduce '
                         'the same tensors')
    for run in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in run])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        off = 0
        for g in run:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def average_metrics(metrics: dict) -> dict:
    """The step's metrics (0-dim tensors) averaged over the data group:
    the global batch's mean losses, where each rank's is its rows' mean
    (metrics that are global already are unchanged). Every data rank must
    call it."""
    group, n, _ = axis_group('data')
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    dev = torch.as_tensor(metrics[keys[0]]).device
    vals = torch.stack([torch.as_tensor(metrics[k], device=dev)
                        .to(torch.float64).reshape(()) for k in keys])
    dist.all_reduce(vals, group=group)
    vals = vals / n
    return {k: vals[i] for i, k in enumerate(keys)}


# ---------------------------------------------------------------------------
# the expert and model axes: parameters split over their groups
# ---------------------------------------------------------------------------

# a split parameter carries its splits as [(axis, dim), ...]
_SHARD_ATTR = '_vtp_shard'


def param_shards(p):
    """The (axis, dim) pairs on which parameter `p` is split."""
    return getattr(p, _SHARD_ATTR, ())


@dataclasses.dataclass
class FFNShard:
    """What a split Mlp or MoEMlp reads in its forward: the groups of its
    axes (None where the axis has size 1) and the first expert it holds."""
    expert_group: Optional[object] = None
    model_group: Optional[object] = None
    expert_offset: int = 0


def _split(module, name, splits, layout):
    """Replace module.`name` by this rank's block of it, split on the
    (axis, dim) pairs of `splits` that have size > 1."""
    p = getattr(module, name)
    data = p.data
    kept = []
    for axis, dim in splits:
        n = layout.size(axis)
        if n == 1:
            continue
        if data.shape[dim] % n:
            raise ValueError(f'{name} of shape {tuple(p.shape)}: dim {dim} '
                             f'does not split over the {n} ranks of the '
                             f'{axis} axis')
        step = data.shape[dim] // n
        data = data.narrow(dim, layout.index(axis) * step, step)
        kept.append((axis, dim))
    q = torch.nn.Parameter(data.clone(), requires_grad=p.requires_grad)
    setattr(q, _SHARD_ATTR, tuple(kept))
    q.vtp_layout = layout
    setattr(module, name, q)


def shard_params(model, layout: Layout):
    """Split the FFNs of `model` (a ViT or a model holding one) over the
    layout's expert and model axes, in place (JAX `_param_spec_for` and
    `_tp_spec`): a MoEMlp's stacked experts over `expert` (each rank holds
    E / n_expert of them) and their hidden dimension over `model`; every
    FFN's fc1 on its output and fc2 on its input over `model` (fc2's bias
    stays whole and is added once, after the all-reduce). Attention and
    everything else stay replicated. Call it before the optimizer is
    built. A split that does not divide raises ValueError. Returns the
    model."""
    from ..models.vit import Int8Linear, Mlp, MoEMlp
    tp = layout.n_model > 1
    for m in model.modules():
        if not isinstance(m, (Mlp, MoEMlp)):
            continue
        if isinstance(m.fc1, Int8Linear) or isinstance(m.fc2, Int8Linear):
            raise NotImplementedError('an int8 FFN (serving only) is not '
                                      'split over processes')
        moe = isinstance(m, MoEMlp)
        if not moe and not tp:
            continue
        if tp:
            _split(m.fc1, 'weight', [('model', 0)], layout)
            _split(m.fc1, 'bias', [('model', 0)], layout)
            _split(m.fc2, 'weight', [('model', 1)], layout)
        offset = 0
        if moe:
            n_exp = m.expert_weight.shape[0]
            _split(m, 'expert_weight', [('expert', 0), ('model', 2)],
                   layout)
            _split(m, 'expert_bias', [('expert', 0)], layout)
            offset = (layout.index('expert') * n_exp // layout.n_expert)
        m.shard = FFNShard(layout.group('expert'), layout.group('model'),
                           offset)
    return model


def is_sharded(model) -> bool:
    return any(param_shards(p) for p in model.parameters())


def split_layout(params):
    """The layout that split any of `params` (shard_params records it), so
    that gathering them needs no active layout; else the active one."""
    for p in params:
        if param_shards(p):
            return p.vtp_layout
    return _ACTIVE


def _group_of(axis):
    return axis_group(axis)[0]


def gather_full(t, splits):
    """The whole tensor of which `t` is this rank's block, split on
    `splits` ((axis, dim) pairs) over the active layout's groups. Built
    with all-reduce (each rank's block placed in zeros), which gloo also
    runs on CUDA tensors. Every rank of those groups must call it."""
    for axis, dim in splits:
        group, n, i = axis_group(axis)
        if group is None:
            continue
        shape = list(t.shape)
        step = shape[dim]
        shape[dim] = step * n
        full = t.new_zeros(shape)
        full.narrow(dim, i * step, step).copy_(t)
        dist.all_reduce(full, group=group)
        t = full
    return t


def local_block(full, splits):
    """This rank's block of a whole tensor split on `splits`."""
    for axis, dim in splits:
        _, n, i = axis_group(axis)
        step = full.shape[dim] // n
        full = full.narrow(dim, i * step, step)
    return full.clone()


@contextlib.contextmanager
def _whole_params(model, fill):
    """Within the block the split parameters of `model` hold whole tensors
    (`fill(p, splits)` gives each), so that state-dict code sees the
    unsplit model; their blocks are put back after it."""
    saved = []
    for p in model.parameters():
        splits = param_shards(p)
        if splits:
            saved.append((p, p.data))
            p.data = fill(p, splits)
    try:
        yield [p for p, _ in saved]
    finally:
        for p, data in saved:
            # a load changed the whole tensor: keep its block
            data.copy_(local_block(p.data, param_shards(p)))
            p.data = data


def full_state_dict(model):
    """model.state_dict() of the unsplit model: the split parameters are
    gathered whole (a collective: every rank of their groups calls it).
    The model's own state dict where nothing is split."""
    if not is_sharded(model):
        return model.state_dict()
    # the gathered tensors are new ones, which the state dict keeps
    with activate(split_layout(model.parameters())), \
            _whole_params(model, lambda p, s: gather_full(p.data, s)):
        return model.state_dict()


def load_full_state_dict(model, state_dict, strict=True):
    """Load the state dict of the unsplit model; each split parameter
    keeps its block."""
    if not is_sharded(model):
        return model.load_state_dict(state_dict, strict=strict)

    def whole(p, splits):
        shape = list(p.shape)
        for axis, dim in splits:
            shape[dim] *= p.vtp_layout.size(axis)
        return p.data.new_empty(shape)

    with activate(split_layout(model.parameters())):
        with _whole_params(model, whole):
            return model.load_state_dict(state_dict, strict=strict)


def global_norm(params, grads=None):
    """The L2 norm of the gradients of `params` (or of `grads`, one per
    parameter) over the whole model: a split parameter's blocks are summed
    over the groups it is split on (optax.global_norm under the mesh). A
    0-dim tensor; torch's get_total_norm where nothing is split."""
    grads = [p.grad for p in params] if grads is None else grads
    if not any(param_shards(p) for p in params):
        return torch.nn.utils.get_total_norm(grads)
    by_axes = {}
    for p, g in zip(params, grads):
        axes = tuple(a for a, _ in param_shards(p))
        by_axes.setdefault(axes, []).append(g)
    total = None
    for axes, gs in by_axes.items():
        sq = torch.nn.utils.get_total_norm(gs).float() ** 2
        for axis in axes:
            group = _group_of(axis)
            if group is not None:
                dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return total.sqrt()


def data_axis_size(batch_size: int, n_expert: int = 1, n_model: int = 1,
                   n_data: Optional[int] = None) -> int:
    """The data axis for a global batch of `batch_size` (JAX loop.py:
    365-367): runtime.n_data where given, else the gcd of the batch and the
    processes left over by the expert and model axes."""
    world = rank_and_world()[1]
    return n_data or math.gcd(batch_size, world // (n_expert * n_model))
