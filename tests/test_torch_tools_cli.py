"""The port's root CLIs of ROADMAP item 14 against the JAX package's, on the
CPU at a small size (ViT width 32, depth 2, 64x48 crops): `test_new`
(worst-first OKS matches, histogram, overlays, AP), `eval_detector`,
`keypoints2coco_without_mmdet`, `publish_model`, `train_comet` (its log
tailer and its run without comet_ml) and the four launchers, one of them
(`dist_train.sh`) run with two gloo ranks.

Both packages get the same weights (seeded numpy variables in the flax
layout, written as the JAX package's .npz) and the same synthetic COCO set.
The port's tools are called in process (`main(argv)` with `--device
cpu`); the JAX tools' functions are loaded from tools/ by file path. The
JAX references run once per module. Tolerances are stated per check.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys
import threading
import time
from datetime import date

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.api.inference import (
    init_pose_model as jax_init_pose_model,
    load_checkpoint_variables as jax_load_checkpoint_variables)
from vitpose_tpu.data import TopDownDataset as JaxTopDownDataset
from vitpose_tpu.data.coco_index import CocoIndex as JaxCocoIndex
from vitpose_tpu.eval.loop import run_validation as jax_run_validation
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.config import load_config as jax_load_config

from test_torch_data import IMAGE_SIZE, write_coco_fixture
from test_torch_eval import (AP_TOL, _jax_loader, _small_config,
                             _write_gt_from, assert_stats_close)
from test_torch_loop import SMALL_OPTIONS, data_options
from test_torch_models import (_compile_fast, _crops, _peaked,
                               _random_variables, _small)
from vitpose_tpu_torch.api import init_pose_model
from vitpose_tpu_torch.models import infer
from vitpose_tpu_torch.tools import eval_detector, test_new, train_comet
from vitpose_tpu_torch.tools.misc import (keypoints2coco_without_mmdet,
                                          publish_model)
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TOOLS = os.path.join(ROOT, 'vitpose_tpu_torch', 'tools')
OKS_TOL = 1e-4          # the OKS of one match: keypoints within 1e-3 px
HM_TOL = 1e-6           # heatmaps of carried-over weights: exact transposes


def _jax_tool(rel):
    """A JAX package tool module, loaded from tools/ by file path."""
    path = os.path.join(ROOT, 'tools', rel)
    spec = importlib.util.spec_from_file_location(
        'jax_tool_' + rel.replace('/', '_')[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """The COCO set (detections, GT rewritten near JAX's predictions), the
    small config, the peaked weights as a JAX .npz, and JAX's
    run_validation results and dataset."""
    root = tmp_path_factory.mktemp('tools')
    coco = write_coco_fixture(str(root / 'val'), seed=1)
    variables = _peaked(_random_variables(1, out_channels=17))
    npz = str(root / 'small.npz')
    save_params_npz(npz, variables)
    jm = JaxTopDown(_small(jax_make_config, out_channels=17))
    results = jax_run_validation(jm, jax.tree.map(jnp.asarray, variables),
                                 _jax_loader(coco))
    _write_gt_from(results, coco, seed=2)
    jds = JaxTopDownDataset(coco['ann'], coco['prefix'], dataset_info='coco',
                            image_size=IMAGE_SIZE, heatmap_size=(12, 16),
                            test_mode=True, use_gt_bbox=False,
                            bbox_file=coco['det'])
    return dict(coco=coco, npz=npz, variables=variables, jm=jm,
                results=results, jds=jds, config=_small_config(root),
                root=root)


def _val_options(coco):
    return ['--cfg-options', f"data.val.ann_file={coco['ann']}",
            f"data.val.img_prefix={coco['prefix']}",
            f"data.val.bbox_file={coco['det']}"]


# --- test_new ----------------------------------------------------------------

def test_test_new_matches_jax(setup, tmp_path):
    """The port's CLI against JAX's `match_predictions` on JAX's results and
    JAX's dataset evaluate: the same persons matched to the same boxes,
    each OKS within OKS_TOL, worst first; AP within AP_TOL; the histogram
    and the overlays written."""
    coco = setup['coco']
    save_dir = str(tmp_path / 'vis')
    out = str(tmp_path / 'stats.json')
    stats, matches = test_new.main(
        [setup['config'], setup['npz'], '--device', 'cpu', '--save-dir',
         save_dir, '--out', out, '--num-images', '4',
         *_val_options(coco)])
    ref = _jax_tool('test_new.py').match_predictions(setup['jds'],
                                                     setup['results'])
    assert len(matches) == len(ref) > 0
    oks = [m[2] for m in matches]
    assert oks == sorted(oks)
    ref_by_gt = {r[1]['id']: r for r in ref}
    for dt, gt, s in matches:
        rdt, _, rs = ref_by_gt[gt['id']]
        assert (dt is None) == (rdt is None), gt['id']
        assert abs(s - rs) <= OKS_TOL, (gt['id'], s, rs)
        if dt is not None:
            assert dt['center'] == pytest.approx(rdt['center'], abs=1e-4)
            assert dt['score'] == pytest.approx(rdt['score'], abs=1e-6)
    with open(coco['ann']) as f:
        assert len(matches) == len(json.load(f)['annotations'])
    assert_stats_close(stats, setup['jds'].evaluate(setup['results']),
                       AP_TOL)
    with open(out) as f:
        assert json.load(f) == {k: float(v) for k, v in stats.items()}
    files = sorted(os.listdir(save_dir))
    assert test_new.HISTOGRAM in files
    drawn = [f for f in files if re.fullmatch(r'\d{4}_vis_.+-\d+\.png', f)]
    expected = test_new.sample_indices(len(matches), 4)
    assert len(drawn) == len(expected) == 4
    assert drawn[0].startswith('0000_vis_')          # the worst match


def test_oks_histogram_counts(tmp_path):
    counts = test_new.oks_histogram(np.array([0.0, 0.05, 0.5, 1.0, 1.2]),
                                    str(tmp_path / 'h.png'), bins=10)
    assert counts.tolist() == [2, 0, 0, 0, 0, 1, 0, 0, 0, 2]
    import cv2
    assert cv2.imread(str(tmp_path / 'h.png')).shape == (480, 640, 3)


# --- eval_detector -----------------------------------------------------------

def test_eval_detector_matches_jax(setup, tmp_path, capsys, monkeypatch):
    """Both tools on the same GT and result jsons print the same stats,
    rounded to 4 places."""
    res = [dict(image_id=setup['jds']._path_to_id(p), category_id=1,
                keypoints=k.reshape(-1).tolist(), score=float(b[5]))
           for r in setup['results']
           for p, k, b in zip(r['image_paths'], r['preds'], r['boxes'])]
    path = str(tmp_path / 'res.json')
    with open(path, 'w') as f:
        json.dump(res, f)
    gt = setup['coco']['ann']
    stats = eval_detector.main([gt, path])
    port = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(sys, 'argv', ['eval_detector.py', gt, path])
    _jax_tool('eval_detector.py').main()
    assert port == json.loads(capsys.readouterr().out)
    assert port == {k: round(float(v), 4) for k, v in stats.items()}
    assert 0 < port['AP'] < 1


# --- keypoints2coco ----------------------------------------------------------

def test_keypoints2coco_matches_jax(setup, tmp_path):
    """Every GT box pseudo-labelled by both packages' top-down API: the
    same annotations, keypoints (int pixels) within one pixel (the float
    keypoints agree to 1e-3 px, and int() may truncate either side of a
    whole pixel), the same visibility flags (no score of the peaked
    weights lies near the threshold)."""
    coco = setup['coco']
    out = str(tmp_path / 'pseudo.json')
    port = keypoints2coco_without_mmdet.main(
        [setup['config'], setup['npz'], '--json-file', coco['ann'],
         '--img-root', coco['prefix'], '--out-json-file', out,
         '--device', 'cpu'])
    with open(out) as f:
        assert json.load(f) == port
    jtool = _jax_tool('misc/keypoints2coco_without_mmdet.py')
    jpm = jax_init_pose_model(setup['config'], checkpoint=setup['npz'])
    ref = jtool.pseudo_label(jpm, JaxCocoIndex(coco['ann']), coco['prefix'])
    assert port['images'] == ref['images']
    assert port['categories'] == ref['categories']
    assert len(port['annotations']) == len(ref['annotations']) > 0
    for p, r in zip(port['annotations'], ref['annotations']):
        for key in ('id', 'image_id', 'bbox', 'area', 'iscrowd'):
            assert p[key] == r[key], key
        pk = np.array(p['keypoints']).reshape(-1, 3)
        rk = np.array(r['keypoints']).reshape(-1, 3)
        np.testing.assert_array_equal(pk[:, 2], rk[:, 2])
        assert np.abs(pk[:, :2] - rk[:, :2]).max() <= 1


def _heatmaps(jm, variables, x):
    return np.asarray(_compile_fast(
        lambda v, x: jm.apply(v, x, train=False),
        jax.tree.map(jnp.asarray, variables), x))


# --- publish_model -----------------------------------------------------------

def test_publish_jax_npz_reads_back_in_jax(setup, tmp_path):
    """A JAX .npz published by the port (--config) is a plain state dict
    under the mmpose names, stamped {stem}-{sha256[:8]}_{date}.pth; JAX's
    load_checkpoint_variables reads it, and its heatmaps equal those of
    the original variables (HM_TOL); the port's init_pose_model reads it
    too."""
    out = publish_model.main([setup['npz'], str(tmp_path / 'vitpose.pth'),
                              '--config', setup['config']])
    assert re.fullmatch(
        r'vitpose-[0-9a-f]{8}_' + date.today().strftime('%Y%m%d') + r'\.pth',
        os.path.basename(out))
    assert not os.path.exists(tmp_path / 'vitpose.pth')
    sd = torch.load(out, weights_only=True)
    assert 'backbone.patch_embed.proj.weight' in sd
    jm = setup['jm']
    cfg = jax_load_config(setup['config'])
    variables = jax_load_checkpoint_variables(out, dict(cfg['model']),
                                              topdown_cfg=jm.cfg)
    x = _crops(21)
    np.testing.assert_allclose(_heatmaps(jm, variables, x),
                               _heatmaps(jm, setup['variables'], x),
                               rtol=0, atol=HM_TOL)
    pm = init_pose_model(setup['config'], out, device='cpu')
    with torch.no_grad():
        hm = infer(pm.model, torch.from_numpy(x))
    np.testing.assert_allclose(hm.numpy(),
                               _heatmaps(jm, setup['variables'], x),
                               rtol=1e-4, atol=1e-4)


def test_publish_strips_a_training_checkpoint(setup, tmp_path):
    """The runner's epoch_{e}.pth: its optimizer and scheduler state, step
    and epoch dropped, the weights kept bit for bit; a .npz without
    --config is refused."""
    pm = init_pose_model(setup['config'], setup['npz'], device='cpu')
    sd = pm.model.state_dict()
    ckpt = str(tmp_path / 'epoch_3.pth')
    torch.save({'model': sd, 'optimizer': {'state': {}, 'param_groups': []},
                'scheduler': {'last_epoch': 7}, 'step': 8, 'epoch': 3},
               ckpt)
    out = publish_model.process_checkpoint(ckpt, str(tmp_path / 'pub.pth'))
    back = torch.load(out, weights_only=True)
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match='--config'):
        publish_model.process_checkpoint(setup['npz'],
                                         str(tmp_path / 'x.pth'))


# --- train_comet -------------------------------------------------------------

class _Experiment:
    def __init__(self):
        self.metrics, self.params, self.assets = [], [], []
        self.ended = False

    def log_metrics(self, metrics, step):
        self.metrics.append((metrics, step))

    def log_parameters(self, params):
        self.params.append(params)

    def log_asset(self, path):
        self.assets.append(path)

    def end(self):
        self.ended = True


LOG_LINES = [
    '{"mode": "train", "epoch": 0, "iter": 0, "step": 1, "loss": 0.5, '
    '"lr": 0.001, "dataset": "coco"}',
    'not json',
    '{"mode": "epoch", "epoch": 0, "AP": 0.25, "epoch_time": 3}',
    '{"mode": "train", "iter": 2, "step": 3, "loss": 0.25}',
]


def test_comet_tailer_matches_jax(tmp_path):
    """The port's tailer, started before the log is complete (a record
    split across two polls), sends the records that JAX's tailer sends in
    one pass over the finished log."""
    path = tmp_path / 'train.log.json'
    text = '\n'.join(LOG_LINES) + '\n'
    cut = text.index('"AP"')
    path.write_text(text[:cut])
    port, stop = _Experiment(), threading.Event()
    t = threading.Thread(target=train_comet._tail_log_to_comet,
                         args=(port, str(path), stop, 0.01))
    t.start()
    deadline = time.time() + 10
    while not port.metrics and time.time() < deadline:
        time.sleep(0.01)
    with open(path, 'a') as f:
        f.write(text[cut:])
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()
    ref, done = _Experiment(), threading.Event()
    done.set()
    _jax_tool('train_comet.py')._tail_log_to_comet(ref, str(path), done)
    assert port.metrics == ref.metrics
    assert [s for _, s in port.metrics] == [1, 0, 3]


def test_train_comet_without_and_with_a_tracker(tmp_path, capsys):
    """Without comet_ml the tool says so and gives no experiment; with an
    experiment, one CPU training step through tools/train.py sends the
    argv, the config and the step's logged record, and ends it."""
    assert train_comet._make_experiment() is None
    assert 'comet_ml not installed' in capsys.readouterr().out
    coco = write_coco_fixture(str(tmp_path / 'data'), seed=0)
    cfg = _small_config(tmp_path)
    work_dir = str(tmp_path / 'wd')
    exp = _Experiment()
    state = train_comet.main(
        [cfg, '--work-dir', work_dir, '--device', 'cpu', '--max-steps', '1',
         '--cfg-options', *SMALL_OPTIONS, *data_options(coco, coco)],
        experiment=exp)
    assert state.step == 1 and exp.ended
    assert exp.assets == [cfg] and cfg in exp.params[0]['argv']
    (metrics, step), = exp.metrics
    assert step == 1 and np.isfinite(metrics['heatmap_loss'])


# --- launchers ---------------------------------------------------------------

def _fake_bin(tmp_path, name):
    """An executable `name` that prints its argv and the launch env."""
    d = tmp_path / 'bin'
    d.mkdir(exist_ok=True)
    p = d / name
    p.write_text('#!/usr/bin/env bash\necho "$0 $*"\n'
                 'echo "COORDINATOR_ADDRESS=${COORDINATOR_ADDRESS:-}"\n'
                 'echo "PYTHONPATH=$PYTHONPATH"\n')
    p.chmod(0o755)
    return str(d)


@pytest.mark.parametrize('script,args,expect', [
    ('dist_test.sh', ['cfg.py', 'ckpt.pth', '--out', 's.json'],
     r'torchrun --nproc_per_node=4 --master_addr=127\.0\.0\.1 '
     r'--master_port=\d+ -m vitpose_tpu_torch\.tools\.test cfg\.py '
     r'ckpt\.pth --out s\.json'),
    ('slurm_train.sh', ['part', 'job', 'cfg.py', 'wd', '--seed', '1'],
     r'srun -p part --job-name=job --gres=gpu:4 --ntasks=4 '
     r'--ntasks-per-node=4 --cpus-per-task=8 --kill-on-bad-exit=1 python '
     r'-u -m vitpose_tpu_torch\.tools\.train cfg\.py --work-dir=wd '
     r'--seed 1'),
    ('slurm_test.sh', ['part', 'job', 'cfg.py', 'ckpt.pth'],
     r'srun -p part --job-name=job --gres=gpu:4 --ntasks=4 '
     r'--ntasks-per-node=4 --cpus-per-task=8 --kill-on-bad-exit=1 python '
     r'-u -m vitpose_tpu_torch\.tools\.test cfg\.py ckpt\.pth'),
], ids=['dist_test', 'slurm_train', 'slurm_test'])
def test_launcher_command_lines(tmp_path, script, args, expect):
    """Four cards: torchrun with one process each, or srun with one task
    each, on the port's CLIs, the repo root on PYTHONPATH and JAX's
    COORDINATOR_ADDRESS left unset."""
    fake = _fake_bin(tmp_path, 'torchrun' if script.startswith('dist')
                     else 'srun')
    env = {k: v for k, v in os.environ.items()
           if k != 'COORDINATOR_ADDRESS'}
    env.update(PATH=fake + os.pathsep + env['PATH'], NPROC='4', GPUS='4')
    out = subprocess.run(['bash', os.path.join(PORT_TOOLS, script), *args],
                         env=env, capture_output=True, text=True, check=True,
                         timeout=60).stdout
    assert re.search(expect, out), out
    assert 'COORDINATOR_ADDRESS=\n' in out
    assert f'PYTHONPATH={ROOT}' in out


def test_dist_train_two_gloo_ranks(tmp_path):
    """dist_train.sh with NPROC=2 on the CPU (gloo): one epoch of 2 steps at
    a global batch of 4 over the 8 training persons; rank 0 alone writes
    the log and the checkpoint."""
    coco = write_coco_fixture(str(tmp_path / 'data'), seed=0)
    work_dir = tmp_path / 'wd'
    env = dict(os.environ, NPROC='2', OMP_NUM_THREADS='1')
    with socket_port() as port:
        env['PORT'] = str(port)
    proc = subprocess.run(
        ['bash', os.path.join(PORT_TOOLS, 'dist_train.sh'),
         _small_config(tmp_path), '--work-dir', str(work_dir), '--device',
         'cpu', '--cfg-options', *SMALL_OPTIONS, *data_options(coco, coco),
         'data.batch_size=4', 'optimizer.total_epochs=1',
         'runtime.eval_interval=0'],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = [json.loads(line) for line in
           (work_dir / 'train.log.json').read_text().splitlines()]
    assert [r['step'] for r in log if r['mode'] == 'train'] == [1, 2]
    assert sorted(os.listdir(work_dir / 'ckpts')) == ['epoch_0.pth',
                                                     'info_0.json']
    ckpt = torch.load(work_dir / 'ckpts' / 'epoch_0.pth', weights_only=True)
    assert ckpt['step'] == 2 and ckpt['epoch'] == 0


class socket_port:
    """A free localhost port (the socket closed on exit)."""

    def __enter__(self):
        import socket
        self.s = socket.socket()
        self.s.bind(('127.0.0.1', 0))
        return self.s.getsockname()[1]

    def __exit__(self, *exc):
        self.s.close()
