"""The port's training runner (`train_model`, the train CLI) against the JAX
package's on the CPU, and its resume and preemption on its own.

The model is the small one of tests/test_torch_models.py (64x48 crops, width
32, depth 2, 4 heads, 17 joints), in f32 with the attention core of
`fused_attention=True` (the plain versions on the CPU on both sides). The
config is the shipped ViTPose-B COCO file, read in place, with the small
geometry, a small optimizer and the data paths set by `--cfg-options`-style
overrides. The train set is the COCO fixture of tests/test_torch_data.py
(8 records, 2 steps of 3 per epoch); the val set is a second fixture whose
GT is rewritten from the port's predictions of the initial weights, so that
AP lies strictly between 0 and 1.

Both runners `load_from` the same .npz of the same numpy variables (peaked
as in tests/test_torch_eval.py), with drop_path 0. Two stand-ins save the
JAX run some fifteen seconds and change nothing compared: its `model.init`
is jitted as one program (the eager values, which load_from replaces
anyway), and its CheckpointManager, which the run returns before using
(max_steps), is a stub that fails if it saves, so orbax is not imported.

Tolerances: per-step heatmap_loss, grad_norm and acc_pose 1e-4 relative, as
tests/test_torch_train.py's 3-step trajectory; the epoch-end COCO stats 1e-6
(tests/test_torch_eval.py's AP tolerance). The parameters and BN statistics
after the run: 1e-4 relative as there, but 5e-5 absolute, not 1e-5, and per
tensor the RMS of the difference at most 1e-2 of the RMS of the 3-step
update. Unlike that test's fixed batch, the runner's crops are warped on
each side with the config's rotations, and the two libraries' sin/cos and
bilinear sums leave them up to 1e-4 apart (test_preprocess_matches_jax); an
element whose gradient is as small as that difference takes a different
share of its Adam step (lr <= 5.5e-4 here). Measured: one element of block
0's attn.proj 1.9e-5 apart, every other within 1e-5, and RMS ratios up to
2.6e-3. Resume and
preemption are the port's own and exact: on the CPU a resumed run equals the
uninterrupted one bit for bit.
"""
import functools
import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.train import loop as jax_loop
from vitpose_tpu.utils.checkpoint import save_params_npz

from test_torch_data import COCO_B, write_coco_fixture
from test_torch_eval import _port_loader, _write_gt_from
from test_torch_models import (SMALL, _peaked, _port_model,
                               _random_variables, _small)
from vitpose_tpu_torch.eval.loop import run_validation
from vitpose_tpu_torch.models import make_config
from vitpose_tpu_torch.tools import train as cli
from vitpose_tpu_torch.train import loop
from vitpose_tpu_torch.utils import config
from vitpose_tpu_torch.utils.checkpoint import CheckpointManager
from vitpose_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

STEPS_PER_EPOCH = 2
METRIC_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
PARAM_RMS_RATIO = 1e-2
AP_TOL = 1e-6
METRICS = ('heatmap_loss', 'grad_norm', 'acc_pose')

# the small model and optimizer over the shipped COCO-B config: the lr of
# steps 0-2 is 1e-4, 5.5e-4 and 1e-4 (warmup of 2, x0.1 from epoch 1) as in
# tests/test_torch_train.py's trajectory, clipped at 0.05
SMALL_OPTIONS = [
    'model.img_size=(64, 48)', 'model.dtype=float32',
    'model.deconv_filters=(16, 16)',
    *(f'model.backbone_overrides.{k}={v}' for k, v in SMALL.items()),
    'model.backbone_overrides.drop_path_rate=0.0',
    'data.image_size=(48, 64)', 'data.heatmap_size=(12, 16)',
    'data.batch_size=3', 'data.num_workers=2',
    'optimizer.base_lr=1e-3', 'optimizer.warmup_iters=2',
    'optimizer.warmup_ratio=0.1', 'optimizer.decay_epochs=(1,)',
    'optimizer.total_epochs=2', 'optimizer.grad_clip_norm=0.05',
    'runtime.log_interval=1', 'runtime.eval_interval=1',
    'runtime.ckpt_interval=1']


def data_options(train, val):
    return [f"data.train.ann_file={train['ann']}",
            f"data.train.img_prefix={train['prefix']}",
            f"data.val.ann_file={val['ann']}",
            f"data.val.img_prefix={val['prefix']}",
            f"data.val.bbox_file={val['det']}"]


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    """{'train', 'val': COCO fixtures, 'npz': the initial weights as the
    JAX package exports them, 'variables': the same as numpy, 'options':
    the config overrides}."""
    root = tmp_path_factory.mktemp('loop')
    train = write_coco_fixture(str(root / 'train'), seed=0)
    val = write_coco_fixture(str(root / 'val'), seed=1)
    variables = _peaked(_random_variables(1, out_channels=17))
    model = _port_model(_small(make_config, out_channels=17), variables)
    _write_gt_from(run_validation(model, _port_loader(val)), val, seed=2)
    npz = str(root / 'init.npz')
    save_params_npz(npz, variables)
    options = SMALL_OPTIONS + data_options(train, val) + [f'load_from={npz}']
    return dict(train=train, val=val, npz=npz, variables=variables,
                options=options, root=root)


def make_cfg(fixture, *options):
    return config.apply_options(config.load_config(COCO_B),
                                fixture['options'] + list(options))


def read_log(work_dir):
    with open(os.path.join(work_dir, 'train.log.json')) as f:
        return [json.loads(line) for line in f]


_eager_init = JaxTopDown.init


def _jitted_init(self, rngs, *args, **kwargs):
    return jax.jit(functools.partial(_eager_init, self, **kwargs))(rngs,
                                                                    *args)


class _NoCheckpoints:
    def __init__(self, *args, **kwargs):
        pass

    def save(self, *args, **kwargs):
        raise AssertionError('the JAX run saved a checkpoint')


# max_steps=3: one epoch with its evaluation, then one step of the next;
# the runners return at max_steps before any checkpoint is written
RUN_OPTIONS = ('runtime.ckpt_interval=10',)
MAX_STEPS = STEPS_PER_EPOCH + 1


@pytest.fixture(scope='module')
def runs(fixture):
    """(JAX log, JAX final variables, port log, port final state)."""
    cfg = make_cfg(fixture, *RUN_OPTIONS)
    jax_dir = str(fixture['root'] / 'jax_run')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTopDown, 'init', _jitted_init)
        mp.setattr(jax_loop, 'CheckpointManager', _NoCheckpoints)
        jstate = jax_loop.train_model(cfg, work_dir=jax_dir,
                                      max_steps=MAX_STEPS)
    jvars = {'params': jax.tree.map(np.asarray, jstate.params),
             'batch_stats': jax.tree.map(np.asarray, jstate.batch_stats)}
    port_dir = str(fixture['root'] / 'port_run')
    state = loop.train_model(cfg, work_dir=port_dir, max_steps=MAX_STEPS,
                             device='cpu')
    return read_log(jax_dir), jvars, read_log(port_dir), state


def test_runner_trajectory_matches_jax(fixture, runs):
    """Per-step metrics of every logged step, and every parameter and BN
    statistic after the run."""
    jlog, jvars, log, state = runs
    jtrain = [r for r in jlog if r['mode'] == 'train']
    train = [r for r in log if r['mode'] == 'train']
    assert [r['step'] for r in train] == [r['step'] for r in jtrain] \
        == list(range(1, MAX_STEPS + 1))
    assert [(r['epoch'], r['iter']) for r in train] == \
        [(r['epoch'], r['iter']) for r in jtrain]
    for r, jr in zip(train, jtrain):
        assert set(r) == set(jr)
        for key in METRICS:
            np.testing.assert_allclose(r[key], jr[key], rtol=METRIC_RTOL,
                                       err_msg=f"step {r['step']} {key}")
        assert r['grad_norm'] > 0.05                 # the clip is active
    assert state.step == MAX_STEPS
    expected = state_dict_from_flax(jvars)
    init = state_dict_from_flax(fixture['variables'])
    for name, value in state.model.state_dict().items():
        if 'num_batches' in name:
            continue
        got, want = value.numpy(), expected[name].numpy()
        np.testing.assert_allclose(got, want, **PARAM_TOL, err_msg=name)
        update = want - init[name].numpy()
        assert np.sqrt(np.mean((got - want) ** 2)) <= PARAM_RMS_RATIO \
            * np.sqrt(np.mean(update ** 2)), name


def test_epoch_end_evaluation_matches_jax(runs):
    jlog, _, log, _ = runs
    (jrec,) = [r for r in jlog if r['mode'] == 'epoch']
    (rec,) = [r for r in log if r['mode'] == 'epoch']
    assert set(rec) == set(jrec)
    assert 0 < rec['AP'] < 1
    for key, value in jrec.items():
        if key not in ('mode', 'epoch', 'epoch_time'):
            assert abs(rec[key] - value) <= AP_TOL, key


def _run(fixture, name, *options, **kw):
    work_dir = str(fixture['root'] / name)
    state = loop.train_model(make_cfg(fixture, *options), work_dir=work_dir,
                             device='cpu', **kw)
    return work_dir, state


# resume and preemption: drop_path 0.3 (the per-step DropPath seeds must
# replay), no evaluation
OWN_OPTIONS = ('model.backbone_overrides.drop_path_rate=0.3',
               'runtime.eval_interval=0')


def _load(path):
    return torch.load(path, map_location='cpu', weights_only=True)


def assert_same(a, b, path='ckpt'):
    """Equal nested checkpoint contents: tensors bit for bit."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{path}[{i}]')
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope='module')
def uninterrupted(fixture):
    """Two epochs with a checkpoint after each."""
    return _run(fixture, 'two_epochs', *OWN_OPTIONS)


def test_resume_equals_the_uninterrupted_run(fixture, uninterrupted):
    """Epoch 1 again from the epoch-0 checkpoint (the epoch-1 one removed
    from a copy of the work dir) gives the same steps, losses and final
    checkpoint, bit for bit."""
    work_dir, state = uninterrupted
    resumed = str(fixture['root'] / 'resumed')
    shutil.copytree(work_dir, resumed)
    os.remove(os.path.join(resumed, 'ckpts', 'epoch_1.pth'))
    os.remove(os.path.join(resumed, 'ckpts', 'info_1.json'))
    log_len = len(read_log(resumed))
    state2 = loop.train_model(make_cfg(fixture, *OWN_OPTIONS),
                              work_dir=resumed, resume=True, device='cpu')
    new = read_log(resumed)[log_len:]
    assert new[0] == {'mode': 'resume', 'epoch': 1}
    ref = [r for r in read_log(work_dir) if r['mode'] == 'train'
           and r['epoch'] == 1]
    got = [r for r in new if r['mode'] == 'train']
    assert [(r['step'], *(r[k] for k in METRICS)) for r in got] == \
        [(r['step'], *(r[k] for k in METRICS)) for r in ref]
    assert state2.step == state.step == 2 * STEPS_PER_EPOCH
    assert_same(_load(os.path.join(resumed, 'ckpts', 'epoch_1.pth')),
                _load(os.path.join(work_dir, 'ckpts', 'epoch_1.pth')))
    assert state2.optimizer.param_groups[0]['lr'] == \
        state.optimizer.param_groups[0]['lr']


def _preempting_step(after, make_train_step):
    """make_train_step whose step sends SIGTERM to this process after its
    `after`-th call."""
    def make(*args, **kw):
        step = make_train_step(*args, **kw)
        calls = [0]

        def preempted(*a):
            out = step(*a)
            calls[0] += 1
            if calls[0] == after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return preempted
    return make


def test_preemption_saves_an_incomplete_epoch_that_resume_redoes(
        fixture, monkeypatch):
    # the guard hands the signal on to the handler it found: a no-op here
    handler = signal.signal(signal.SIGTERM, lambda signum, frame: None)
    try:
        noop = signal.getsignal(signal.SIGTERM)
        k = STEPS_PER_EPOCH + 1                    # epoch 1, after iter 0
        with monkeypatch.context() as mp:
            mp.setattr(loop, 'make_train_step',
                       _preempting_step(k, loop.make_train_step))
            work_dir, state = _run(fixture, 'preempted', *OWN_OPTIONS)
        assert signal.getsignal(signal.SIGTERM) is noop
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert state.step == k
    assert read_log(work_dir)[-1] == {'mode': 'preempt', 'epoch': 1,
                                      'step': k}
    ckpt = CheckpointManager(os.path.join(work_dir, 'ckpts'))
    assert ckpt.epochs() == [0, 1]
    assert ckpt.load_info(1)['meta'] == {'completed': False}
    assert ckpt.load_info(0)['meta'] == {}
    assert _load(ckpt.path(1))['step'] == k

    state = loop.train_model(make_cfg(fixture, *OWN_OPTIONS),
                             work_dir=work_dir, resume=True, device='cpu')
    log = read_log(work_dir)
    resume = log.index({'mode': 'resume', 'epoch': 1})
    assert [(r['epoch'], r['iter']) for r in log[resume + 1:]
            if r['mode'] == 'train'] == [(1, i)
                                         for i in range(STEPS_PER_EPOCH)]
    assert state.step == k + STEPS_PER_EPOCH
    assert ckpt.load_info(1)['meta'] == {}


def test_frozen_stages_through_the_runner(fixture):
    """optimizer.frozen_stages=1: patch_embed and block 1 stay at the
    load_from weights, block 0 and the head train; grad_norm counts the
    frozen gradients, so it is larger than the trainable ones' norm."""
    _, state = _run(fixture, 'frozen', 'optimizer.frozen_stages=1',
                    max_steps=2)
    init = state_dict_from_flax(fixture['variables'])
    for name, value in state.model.named_parameters():
        frozen = 'patch_embed' in name or 'blocks.1.' in name
        assert torch.equal(value, init[name]) == frozen, name
    trainable = {id(p) for g in state.optimizer.param_groups
                 for p in g['params']}
    every = [p.grad for p in state.model.parameters()]
    assert len(trainable) < len(every)
    kept = [p.grad for p in state.model.parameters() if id(p) in trainable]
    assert torch.nn.utils.get_total_norm(every) > \
        torch.nn.utils.get_total_norm(kept)


# --- the CLI --------------------------------------------------------------

def test_cli_trains_in_process(fixture, tmp_path, monkeypatch):
    """main([...]) on a config file whose data paths start with 'data/',
    rewritten by PATH_TO_DATA, with --max-steps 2 and --seed: two logged
    steps, no checkpoint."""
    path = tmp_path / 'small.py'
    path.write_text(
        f"_base_ = ['{COCO_B}']\n"
        "data = dict(train=dict(ann_file='data/train/ann.json',\n"
        "                       img_prefix='data/train/'),\n"
        "            val=dict(ann_file='data/val/ann.json',\n"
        "                     img_prefix='data/val/',\n"
        "                     bbox_file='data/val/det.json'))\n")
    monkeypatch.setenv('PATH_TO_DATA', str(fixture['root']))
    work_dir = str(tmp_path / 'wd')
    state = cli.main([str(path), '--work-dir', work_dir, '--device', 'cpu',
                      '--max-steps', '2', '--seed', '3', '--cfg-options',
                      *SMALL_OPTIONS, f"load_from={fixture['npz']}"])
    log = read_log(work_dir)
    assert [r['step'] for r in log if r['mode'] == 'train'] == [1, 2]
    assert all(np.isfinite(r['heatmap_loss']) for r in log)
    assert state.step == 2
    assert os.listdir(os.path.join(work_dir, 'ckpts')) == []


@pytest.mark.parametrize('case', ['cuda', 'family', 'moe', 'zero1',
                                  'tensorboard'])
def test_cli_refuses_unported(fixture, tmp_path, monkeypatch, case):
    args = [COCO_B, '--work-dir', str(tmp_path), '--device', 'cpu',
            '--cfg-options']
    if case == 'cuda':
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        args[4] = 'cuda'
    elif case == 'family':
        # every family of the zoo trains since item 12f; one the zoo does
        # not have is refused
        args.append('model.family=nerf')
    elif case == 'moe':
        # a ViTPose+ mixture whose augmentation is not ported: every dataset
        # class is (PoseTrack18 and JHMDB since item 12d); albumentations
        # needs a package neither machine has
        args += [f"data.train=[{{'dataset': 'coco', 'ann_file': "
                 f"'{fixture['train']['ann']}', 'img_prefix': "
                 f"'{fixture['train']['prefix']}'}}]",
                 "data.aug.albumentations=[{'type': 'Blur'}]"]
    else:
        args.append(f'runtime.{case}=True')
    item = {'cuda': 'CUDA is not available',
            'family': 'unknown model family', 'moe': 'Not queued',
            'zero1': 'item 11', 'tensorboard': 'Not queued'}
    with pytest.raises((NotImplementedError, RuntimeError, KeyError),
                       match=item[case]):
        cli.main(args)


def test_seed_and_thread_limits(monkeypatch):
    from vitpose_tpu_torch.parallel import init_random_seed
    from vitpose_tpu_torch.utils.env import setup_multi_processes
    assert init_random_seed(7) == 7
    seed = init_random_seed()
    assert isinstance(seed, int) and 0 <= seed < 2 ** 31
    assert loop.step_seed(0, 5) == loop.step_seed(0, 5) \
        != loop.step_seed(0, 6) != loop.step_seed(1, 5)
    monkeypatch.delenv('OMP_NUM_THREADS', raising=False)
    monkeypatch.setenv('MKL_NUM_THREADS', '4')
    setup_multi_processes({'data': {'num_workers': 1}})
    assert 'OMP_NUM_THREADS' not in os.environ
    setup_multi_processes({'data': {'num_workers': 8}})
    assert os.environ['OMP_NUM_THREADS'] == '1'
    assert os.environ['MKL_NUM_THREADS'] == '4'
