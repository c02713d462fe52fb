"""One rank of the two-process gloo group that a tests/test_torch_dist*.py
file starts, and the cases it runs:

    python tests/torch_dist_worker.py SPEC RANK

SPEC is a pickle {'store': file rendezvous path, 'world': 2, 'timeout':
seconds, 'out': result path with a %d for the rank, 'cases': [(name,
kwargs), ...]}; each case is a function of this module called as
name(rank=rank, **kwargs), whose result (numpy arrays in dicts and lists)
is pickled under its name. The worker imports torch and the port only, not
JAX, so it starts in a few seconds; the test computes the JAX references
while it runs. Every collective of the group gives up after `timeout`, and
a module call of a BatchNorm layer raises: every BN of the port goes
through `models.heads.batch_norm`, which is what syncs across ranks.

Most cases run the port's step twice: in one process over the whole global
batch with no layout active (rank 0 only), and across the two ranks, each
on its rows r, r + 2, ... (`shard_rows`), and return both.
"""
import copy
import dataclasses
import datetime
import os
import pickle
import sys

import numpy as np
import torch


def _np(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _tensors(batch, keep=('dataset_idx',)):
    return {k: (v if k in keep else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in batch.items()}


def _both(rank, run, layout):
    """run() in one process with no layout active (rank 0 only), then under
    `layout` on every rank: {'one': ..., 'dist': ...}."""
    from vitpose_tpu_torch.parallel.mesh import activate
    out = {}
    if rank == 0:
        with activate(None):
            out['one'] = run(False)
    with activate(layout):
        out['dist'] = run(True)
    return out


# --- top-down ----------------------------------------------------------------

SMALL = dict(embed_dim=32, depth=2, num_heads=4)


def small_config(out_channels=5, heads=None, **backbone):
    """The tests' small ViTPose (64x48, width 32, depth 2, deconv 16 wide;
    tests/test_torch_models.py `_small`), with associate heads of `heads`
    channels where given."""
    from vitpose_tpu_torch.models import make_config
    cfg = make_config('b', img_size=(64, 48), out_channels=out_channels)
    bb = dataclasses.replace(cfg.backbone, **SMALL, **backbone)
    cfg = dataclasses.replace(cfg, backbone=bb, deconv_filters=(16, 16))
    if heads:
        cfg = dataclasses.replace(cfg, num_extra_heads=len(heads),
                                  extra_head_channels=tuple(heads))
    return cfg


def _optim(optim):
    from vitpose_tpu_torch.train import OptimConfig
    return OptimConfig(**optim)


def topdown_steps(rank, model_path, batches, optim, cfg_kw, zero1=False,
                  moe_heads=None, layout=None, drop_seed=None):
    """Steps of the ViT runner's state and step (make_train_step, or
    make_moe_train_step with `moe_heads` datasets) from the weights in
    `model_path`, one a batch of `batches` (global batches). `layout`:
    (n_data, n_expert, n_model) of the two ranks; the expert and model axes
    split the FFNs (shard_params), zero1 splits AdamW's moments. Returns,
    per run, the metrics of each step, the whole state dict after the
    last, and the parameter names whose AdamW state this rank holds."""
    from vitpose_tpu_torch.models import TopDownModel
    from vitpose_tpu_torch.parallel import make_mesh, shard_params
    from vitpose_tpu_torch.parallel.mesh import (average_metrics,
                                                 full_state_dict,
                                                 shard_rows)
    from vitpose_tpu_torch.parallel.zero import zero1 as zero1_
    from vitpose_tpu_torch.train import (create_train_state,
                                         layer_decay_adamw,
                                         make_moe_train_step,
                                         make_train_step)
    sd = torch.load(model_path, weights_only=True)
    n_data, n_expert, n_model = layout or (2, 1, 1)
    mesh = make_mesh(n_data, n_expert, n_model)

    def run(split):
        model = TopDownModel(small_config(**cfg_kw))
        model.load_state_dict(sd)
        if split and n_expert * n_model > 1:
            shard_params(model, mesh)
        cfg = _optim(optim)
        opt, sched = layer_decay_adamw(model, cfg, 1)
        if split and zero1:
            zero1_(opt)
        state = create_train_state(model, (opt, sched), cfg.grad_clip_norm)
        step = (make_moe_train_step(model, moe_heads) if moe_heads
                else make_train_step(model))
        gen = torch.Generator()
        metrics = []
        for i, b in enumerate(batches):
            gen.manual_seed(1000 + i if drop_seed is None else drop_seed + i)
            tb = _tensors(shard_rows(b) if split else b)
            metrics.append(_metrics(average_metrics(step(state, tb, gen))))
        names = {id(p): n for n, p in model.named_parameters()}
        owned = sorted(names[id(p)] for p in opt.state)
        return dict(metrics=metrics, sd=_np(full_state_dict(model)),
                    owned=owned)

    return _both(rank, run, mesh)


def bn_stats(rank, model_path, imgs, target, weight):
    """The BN running statistics after one training-mode step of
    the small ViTPose's classic head (mirroring tests/test_bn_mesh.py):
    over the whole batch in one process ('one'), across the two ranks
    ('dist'), and over this rank's rows alone ('local')."""
    from vitpose_tpu_torch.parallel import make_mesh
    from vitpose_tpu_torch.parallel.mesh import activate, shard_rows
    sd = torch.load(model_path, weights_only=True)
    mesh = make_mesh(2)
    batch = dict(imgs=imgs, target=target, target_weight=weight)
    out = _both(rank, lambda split: _bn_after_step(
        sd, shard_rows(batch) if split else batch), mesh)
    with activate(mesh):
        rows = shard_rows(batch)
    out['local'] = _bn_after_step(sd, rows)
    return out


def _bn_after_step(sd, batch):
    from vitpose_tpu_torch.models import TopDownModel
    from vitpose_tpu_torch.train import (create_train_state,
                                         layer_decay_adamw, make_train_step)
    model = TopDownModel(small_config())
    model.load_state_dict(sd)
    # the statistics come from the forward, before any update
    cfg = _optim(dict(base_lr=1e-3, num_layers=2))
    state = create_train_state(model, layer_decay_adamw(model, cfg, 1), 1.0)
    make_train_step(model)(state, _tensors(batch), torch.Generator())
    return {k: v for k, v in _np(model.state_dict()).items()
            if 'running_' in k}


def cnn_steps(rank, mdict, model_path, batches, optim, f64=False):
    """Steps of a CNN top-down model of the config dict `mdict` (HRNet:
    its BN syncs across the ranks) through the runner's state and step;
    with `f64` the model, its weights and the batches in float64."""
    from vitpose_tpu_torch.parallel import make_mesh
    from vitpose_tpu_torch.parallel.mesh import average_metrics, shard_rows
    from vitpose_tpu_torch.train import (create_train_state,
                                         layer_decay_adamw, make_train_step)
    from vitpose_tpu_torch.train.loop import build_model_from_cfg
    sd = torch.load(model_path, weights_only=True)
    mesh = make_mesh(2)
    if f64:
        mdict = dict(mdict, dtype='float64', backbone_overrides=dict(
            mdict.get('backbone_overrides', {}), dtype='float64'))
        batches = [{k: v.astype(np.float64) for k, v in b.items()}
                   for b in batches]

    def run(split):
        model = build_model_from_cfg(copy.deepcopy(mdict))
        model.load_state_dict(sd)
        if f64:
            model.double()
        cfg = _optim(optim)
        state = create_train_state(model, layer_decay_adamw(model, cfg, 1),
                                   cfg.grad_clip_norm)
        step = make_train_step(model)
        metrics = []
        for b in batches:
            tb = _tensors(shard_rows(b) if split else b)
            metrics.append(_metrics(average_metrics(
                step(state, tb, torch.Generator()))))
        return dict(metrics=metrics, sd=_np(model.state_dict()))

    return _both(rank, run, mesh)


# --- the families ------------------------------------------------------------

def _resnet10():
    """Depth 10 in the port's RESNET_SPECS (one basic block a stage), as
    tests/test_torch_interhand3d.py `resnet10` patches it in the test."""
    from vitpose_tpu_torch.models import resnet
    resnet.RESNET_SPECS[10] = ('basic', (1, 1, 1, 1))


def _as_tensors(x, f64):
    """numpy (in dicts, tuples and lists) -> CPU tensors, floats in f64
    where `f64`."""
    if isinstance(x, dict):
        return {k: _as_tensors(v, f64) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_as_tensors(v, f64) for v in x)
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.double() if f64 and t.is_floating_point() else t


def _f64(t):
    return t.double() if torch.is_tensor(t) and t.is_floating_point() else t


def _moments(opt, model, prefix=''):
    return {prefix + n: opt.state[p]['exp_avg'].detach().numpy().copy()
            for n, p in model.named_parameters() if p in opt.state}


def family_step(rank, family, mdict, model_path, batch, lr, f64=False,
                resnet10=False, **kw):
    """One step of a family's loop step (train/*_loop.py) from the weights
    in `model_path` on the global `batch` (numpy): the losses, the whole
    state dict after it and Adam's first moments (0.1 times the step's
    gradients), by parameter name; in float64 where `f64`."""
    from vitpose_tpu_torch.parallel import make_mesh
    from vitpose_tpu_torch.parallel.mesh import average_metrics, shard_rows
    from vitpose_tpu_torch.train.family_loop import adam
    from vitpose_tpu_torch.train.loop import build_model_from_cfg
    if resnet10:
        _resnet10()
    sd = torch.load(model_path, weights_only=True)
    mesh = make_mesh(2)

    def build(sd_part):
        m = build_model_from_cfg(copy.deepcopy(mdict))
        m.load_state_dict(sd_part)
        return m.double() if f64 else m

    def run(split):
        b = shard_rows(batch) if split else batch
        const = lambda c: lr  # noqa: E731
        if family == 'mesh':
            from vitpose_tpu_torch.models.mesh import (SMPLDiscriminator,
                                                       adversarial_step)
            from vitpose_tpu_torch.train.mesh_loop import (
                DISC_PREFIX, mesh_batch_to_device)
            n = len(DISC_PREFIX)
            model = build({k: v for k, v in sd.items()
                           if not k.startswith(DISC_PREFIX)})
            disc = SMPLDiscriminator(kw['disc_hidden'])
            disc.load_state_dict({k[n:]: v for k, v in sd.items()
                                  if k.startswith(DISC_PREFIX)})
            gen_opt, gen_sched = adam(model.parameters(), lr, const)
            disc_opt, disc_sched = adam(disc.parameters(), lr, const)
            pb = mesh_batch_to_device(b, 'cpu')
            if f64:
                pb['imgs'] = pb['imgs'].double()
            m = adversarial_step(model, disc, gen_opt, disc_opt, pb,
                                 gen_sched=gen_sched, disc_sched=disc_sched)
            out_sd = dict(model.state_dict())
            out_sd.update({DISC_PREFIX + k: v
                           for k, v in disc.state_dict().items()})
            mu = dict(_moments(gen_opt, model),
                      **_moments(disc_opt, disc, DISC_PREFIX))
            return dict(metrics=_metrics(average_metrics(m)),
                        sd=_np(out_sd), mu=mu)
        model = build(sd)
        if family == 'bottomup':
            from vitpose_tpu_torch.train import bottomup_loop as bl
            state = bl.bottomup_train_state(model, lr, [])
            m = bl.make_bottomup_train_step(model)(
                state, bl.batch_to_device(b, 'cpu'))
            opt = state.optimizer
        elif family == 'posewarper':
            from vitpose_tpu_torch.train import posewarper_loop as pl
            opt, sched = adam(pl.trainable_parameters(
                model, {'model': mdict}), lr, const)
            t = _as_tensors(b, f64)
            m = pl.posewarper_step(model, opt, sched, t['frames'],
                                   t['target'], t['weight'],
                                   _as_tensors(kw['frame_weight'], f64))
        elif family == 'lifter':
            from vitpose_tpu_torch.train import lifter_loop as ll
            opt, sched = adam(model.parameters(), lr, const)
            gen = torch.Generator().manual_seed(5)
            t = _as_tensors(b, f64)
            if kw.get('semi'):
                m = ll.lifter_semi_step(model, opt, sched, *t, 1.0, gen,
                                        kw['scfg'])
            else:
                m = ll.lifter_step(model, opt, sched, *t, gen, kw['loss'])
        elif family == 'interhand3d':
            from vitpose_tpu_torch.train import interhand_loop as il
            opt, sched = adam(model.parameters(), lr, const,
                              weight_decay=kw['weight_decay'])
            pb = il.batch_to_device(b, 'cpu')
            if f64:
                pb = {k: v.double() for k, v in pb.items()}
            m = il.interhand_step(model, opt, sched, pb,
                                  root_depth_bins=kw['root_depth_bins'])
        elif family == 'voxelpose':
            from vitpose_tpu_torch.train import voxelpose_loop as vl
            opt, sched = adam(model.parameters(), lr, const)
            pb = vl.stack_frames(b, 'cpu')
            if f64:
                pb = {k: ({c: _f64(x) for c, x in v.items()}
                          if isinstance(v, dict) else _f64(v))
                      for k, v in pb.items()}
            m = vl.voxelpose_step(model, opt, sched, pb)
        else:
            raise KeyError(family)
        return dict(metrics=_metrics(average_metrics(m)),
                    sd=_np(model.state_dict()), mu=_moments(opt, model))

    return _both(rank, run, mesh)


# --- the CLIs ----------------------------------------------------------------

def train_cli(rank, args):
    """The training CLI with `args` on both ranks (the group is up, so its
    init_distributed returns it): the state's head lr (the base lr that
    --autoscale-lr scaled), its whole state dict, and how many files this
    rank wrote through the checkpoint manager."""
    from vitpose_tpu_torch.tools import train as cli
    from vitpose_tpu_torch.utils import checkpoint
    writes = []
    save = checkpoint._save

    def counting(obj, path):
        writes.append(path)
        save(obj, path)
    checkpoint._save = counting
    try:
        state = cli.main(list(args))
    finally:
        checkpoint._save = save
    from vitpose_tpu_torch.parallel.mesh import full_state_dict
    return dict(lr=max(state.scheduler.base_lrs), writes=len(writes),
                sd=_np(full_state_dict(state.model)), step=state.step)


def eval_cli(rank, args):
    """The evaluation CLI with `args` (a --tmpdir gather over the ranks):
    its return (rank 0's stats, None elsewhere) and the bbox ids that rank
    0 merged."""
    from vitpose_tpu_torch.tools import test as cli
    merged = []
    collect = cli.collect_results

    def recording(results, tmpdir):
        out = collect(results, tmpdir)
        if out is not None:
            merged.extend(i for r in out for i in r['bbox_ids'])
        return out
    cli.collect_results = recording
    try:
        stats = cli.main(list(args))
    finally:
        cli.collect_results = collect
    return dict(stats=None if stats is None else
                {k: float(v) for k, v in stats.items()}, bbox_ids=merged)


# --- the group ---------------------------------------------------------------

class DistRun:
    """The two ranks of one test file, started at construction: python
    processes of this module rendezvousing through a file store in
    `tmp_dir` (so that pytest-xdist workers never compete for a port).
    `results()` waits for both, at most `timeout` seconds, and returns
    each rank's pickled results; a rank that fails or a run that overstays
    kills both and raises with the ranks' output. `kill()` ends whatever
    still runs, `close()` also its logs (the fixture's teardown)."""

    def __init__(self, tmp_dir, cases, timeout=120.0, world=2):
        import subprocess
        import time
        tmp_dir = str(tmp_dir)
        self.out = os.path.join(tmp_dir, 'rank%d.pkl')
        self.timeout = timeout
        spec = dict(store=os.path.join(tmp_dir, 'store'), world=world,
                    timeout=timeout, out=self.out, cases=cases)
        path = os.path.join(tmp_dir, 'spec.pkl')
        with open(path, 'wb') as f:
            pickle.dump(spec, f)
        env = dict(os.environ, OMP_NUM_THREADS='1')
        self.logs = [open(os.path.join(tmp_dir, f'rank{r}.log'), 'w+')
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path, str(r)],
            stdout=log, stderr=subprocess.STDOUT, env=env)
            for r, log in enumerate(self.logs)]
        self.start = time.time()
        self._results = None

    def _output(self):
        text = []
        for r, log in enumerate(self.logs):
            log.flush()
            log.seek(0)
            text.append(f'--- rank {r} ---\n' + log.read()[-4000:])
        return '\n'.join(text)

    def results(self):
        import time
        if self._results is not None:
            return self._results
        while True:
            codes = [p.poll() for p in self.procs]
            if any(c not in (None, 0) for c in codes):
                self.kill()
                raise AssertionError(f'a rank failed ({codes}):\n'
                                     + self._output())
            if all(c == 0 for c in codes):
                break
            if time.time() - self.start > self.timeout:
                self.kill()
                raise AssertionError(f'the ranks overstayed {self.timeout} '
                                     's:\n' + self._output())
            time.sleep(0.05)
        self._results = []
        for r in range(len(self.procs)):
            with open(self.out % r, 'rb') as f:
                self._results.append(pickle.load(f))
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def close(self):
        self.kill()
        for log in self.logs:
            log.close()


# --- the worker --------------------------------------------------------------

def _no_bn_module_calls():
    """A BatchNorm module call raises: the port's BNs go through
    `heads.batch_norm`, which syncs; a module call would not."""
    from torch.nn.modules.batchnorm import _BatchNorm

    def refuse(self, x):
        raise AssertionError(f'{type(self).__name__} called as a module: '
                             'its statistics would not sync across ranks')
    _BatchNorm.forward = refuse


def main(spec_path, rank):
    with open(spec_path, 'rb') as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    from vitpose_tpu_torch.parallel import init_distributed
    init_distributed(device='cpu', init_method='file://' + spec['store'],
                     rank=rank, world_size=spec['world'],
                     timeout=datetime.timedelta(seconds=spec['timeout']))
    _no_bn_module_calls()
    module = sys.modules[__name__]
    out = {}
    for name, kwargs in spec['cases']:
        out[name] = getattr(module, name.split(':')[0])(rank=rank, **kwargs)
    with open(spec['out'] % rank, 'wb') as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1], int(sys.argv[2]))
