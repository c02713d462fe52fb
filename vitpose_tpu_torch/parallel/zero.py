"""ZeRO stage 1: the optimizer's moments split over the data group, and the
whole optimizer state for checkpoints.

Counterpart of `shard_state(zero1=True)` in vitpose_tpu/parallel/mesh.py
:140-183, which shards each Adam moment leaf over `data` and lets XLA
gather where the update needs it. Here each parameter has one owner among
the data ranks (greedy by size, the same on every rank): only the owner
keeps its AdamW state and steps it, and after the step each owner
broadcasts its parameters to the others, so the parameters stay
replicated. The update is elementwise, so the step equals the replicated
one. The optimizer's param groups (the layer-decay groups, their lr scales
and weight decays) stay as they were, each holding its owned parameters,
so the LR schedule drives them unchanged; on CUDA the step counts stay on
the card (`capturable`). Only all_reduce and broadcast are used: gloo has
no reduce_scatter, and gloo reduces CUDA tensors with these two alone.

`full_optimizer_state_dict` gives the state dict the unsplit optimizer
would have (every rank calls it; the moments are broadcast from their
owners and, for parameters split over the expert or model axis, gathered
whole), so a checkpoint reads back at any layout;
`load_full_optimizer_state_dict` keeps this rank's part of one.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .mesh import (_buckets, activate, axis_group, gather_full, local_block,
                   param_shards, split_layout)


@dataclasses.dataclass
class ZeroState:
    """The whole optimizer's parameters, per param group, and the data rank
    that owns each (by id)."""
    groups: list
    owner: dict
    group: object
    n: int
    rank: int


def _owners(params, n):
    """Each parameter's owner: the largest first, each to the least loaded
    rank (ties to the lowest)."""
    load = [0] * n
    owner = {}
    for i in sorted(range(len(params)), key=lambda i: (-params[i].numel(),
                                                       i)):
        r = min(range(n), key=lambda r: (load[r], r))
        owner[id(params[i])] = r
        load[r] += params[i].numel()
    return owner


def zero1(optimizer):
    """Split `optimizer`'s state over the active data group, in place
    (ZeRO-1); the optimizer itself where there is no data group (an axis
    of size 1 from make_mesh), as JAX's shard_state leaves the state where
    n_data <= 1. Build it over every rank's same parameters, before its
    first step."""
    group, n, rank = axis_group('data')
    if group is None:
        return optimizer
    if optimizer.state:
        raise ValueError('zero1: the optimizer has stepped already')
    groups = [list(g['params']) for g in optimizer.param_groups]
    owner = _owners([p for g in groups for p in g], n)
    for g in optimizer.param_groups:
        g['params'] = [p for p in g['params'] if owner[id(p)] == rank]
    optimizer.vtp_zero = ZeroState(groups, owner, group, n, rank)
    return optimizer


def optimizer_params(optimizer):
    """Every parameter the optimizer updates, on any rank, in its groups'
    order."""
    z = getattr(optimizer, 'vtp_zero', None)
    groups = z.groups if z else [g['params'] for g in optimizer.param_groups]
    return [p for g in groups for p in g]


def zero1_sync(optimizer):
    """After a ZeRO-1 step: every owner's parameters broadcast to the other
    data ranks (no-op for an optimizer that zero1 did not split)."""
    z = getattr(optimizer, 'vtp_zero', None)
    if z is None:
        return
    params = optimizer_params(optimizer)
    with torch.no_grad():
        for o in range(z.n):
            owned = [p.data for p in params if z.owner[id(p)] == o]
            src = dist.get_global_rank(z.group, o)
            for run in _buckets(owned):
                flat = torch.cat([t.reshape(-1) for t in run])
                dist.broadcast(flat, src=src, group=z.group)
                if z.rank != o:
                    off = 0
                    for t in run:
                        t.copy_(flat[off:off + t.numel()].view_as(t))
                        off += t.numel()


_MOMENTS = ('exp_avg', 'exp_avg_sq')


def _is_split(optimizer):
    return getattr(optimizer, 'vtp_zero', None) is not None or any(
        param_shards(p) for p in optimizer_params(optimizer))


def _hyper(optimizer):
    return [{k: v for k, v in g.items() if k != 'params'}
            for g in optimizer.param_groups]


def full_optimizer_state_dict(optimizer):
    """The state dict of the optimizer over every parameter, whole (see the
    module docstring); every rank of the layout calls it. The optimizer's
    own state dict where nothing is split."""
    if not _is_split(optimizer):
        return optimizer.state_dict()
    with activate(split_layout(optimizer_params(optimizer))):
        return _full_state_dict(optimizer)


def _full_state_dict(optimizer):
    z = getattr(optimizer, 'vtp_zero', None)
    params = optimizer_params(optimizer)
    groups = z.groups if z else [g['params'] for g in optimizer.param_groups]
    stepped = torch.tensor([float(bool(optimizer.state))])
    if z is not None:
        # a rank that owns nothing has no state of its own to look at
        dist.all_reduce(stepped, group=z.group)
    state = {}
    if stepped.item() > 0:
        for i, p in enumerate(params):
            owner = z.owner[id(p)] if z else None
            st = optimizer.state.get(p)
            dev = p.device
            if owner is None or owner == z.rank:
                step = st['step'].reshape(1).to(dev, torch.float32)
                moms = [st[k] for k in _MOMENTS]
            else:
                step = torch.zeros(1, device=dev)
                moms = [torch.zeros_like(p) for _ in _MOMENTS]
            if owner is not None:
                flat = torch.cat([step] + [m.reshape(-1) for m in moms])
                dist.broadcast(flat, src=dist.get_global_rank(z.group,
                                                              owner),
                               group=z.group)
                step = flat[:1]
                moms = [flat[1 + j * p.numel():1 + (j + 1) * p.numel()]
                        .view_as(p) for j in range(len(_MOMENTS))]
            full = {'step': step.reshape(()).cpu()}
            for k, m in zip(_MOMENTS, moms):
                full[k] = gather_full(m, param_shards(p)).cpu()
            state[i] = full
    index = {id(p): i for i, p in enumerate(params)}
    return {'state': state,
            'param_groups': [dict(h, params=[index[id(p)] for p in g])
                             for h, g in zip(_hyper(optimizer), groups)]}


def load_full_optimizer_state_dict(optimizer, state_dict):
    """Load a state dict of the optimizer over every parameter: this rank
    keeps the state of the parameters it steps, each split parameter's
    moments cut to its block."""
    if not _is_split(optimizer):
        optimizer.load_state_dict(state_dict)
        return
    with activate(split_layout(optimizer_params(optimizer))):
        _load_state_dict(optimizer, state_dict)


def _load_state_dict(optimizer, state_dict):
    full_index = {id(p): i for i, p in enumerate(optimizer_params(optimizer))}
    state, groups, j = {}, [], 0
    for g, saved in zip(optimizer.param_groups,
                        state_dict['param_groups']):
        idx = []
        for p in g['params']:
            st = state_dict['state'].get(full_index[id(p)])
            if st is not None:
                st = dict(st)
                for k in _MOMENTS:
                    st[k] = local_block(st[k], param_shards(p))
                state[j] = st
            idx.append(j)
            j += 1
        groups.append(dict({k: v for k, v in saved.items()
                            if k != 'params'}, params=idx))
    optimizer.load_state_dict({'state': state, 'param_groups': groups})
