"""The entry points on item 12b's models against the JAX package on the CPU:
two training steps of MSPN, Lite-HRNet and CPM, the evaluation CLI on the
zoo's MSPN-50 config ('megvii' decode), and the training CLI on the zoo's
3xRSN-50 config with --resume.

  * Train steps: the tiny models of tests/test_torch_cnn_ms.py, cut
    further (TRAIN_CASES): MSPN with two stages of two units, so the loss
    sums four unit maps and the gradients cross the stages' skips and cross
    conv; Lite-HRNet with three branches, whose last fusion of the lower two
    the loss does not reach (zero gradients, which AdamW still decays, as
    optax does); CPM's two stages with the identity head, the port and
    JAX in float64 (see F64_STEPS). JAX variables
    from a seeded numpy generator carried through
    `cnn_state_dict_from_flax`, 2 crops, MSRA targets, lr 1e-5, held as
    tests/test_torch_cnn.py holds HRNetV2's (`assert_train_steps_match`).
  * Evaluation: `coco/mspn50_coco_256x192.py` cut by --cfg-options (one
    block per unit, units 16 wide, the trunk's top 16 wide, 64x48 crops),
    f32, the config's 'megvii' decode (kernel 5), on the COCO fixture of
    tests/test_torch_data.py; the GT rewritten from the port's predictions
    so that AP lies strictly between 0 and 1; the CLI reads an .npz of the
    JAX variables, which JAX's run_validation + evaluate run on, held to
    1e-6 as tests/test_torch_cnn_more_paths.py holds ViPNAS-MBv3's.
  * Training CLI: `coco/3xrsn50_coco_256x192.py` cut to one block per unit,
    two units, 64x48 crops, f32, on that fixture: one epoch of two steps,
    then --resume for a second epoch equals two epochs at once bit for bit.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from vitpose_tpu.eval.loop import run_validation as jax_run_validation
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.config import apply_options as jax_apply_options
from vitpose_tpu.utils.config import load_config as jax_load_config

from test_torch_cnn import TRAIN_OPTIM, assert_train_steps_match, \
    jax_train_steps
from test_torch_cnn_more_paths import train_batch
from test_torch_cnn_ms import (jax_variables, model_dict,  # noqa: F401
                               one_torch_thread, port_model)
from test_torch_cnn_paths import COCO_CFG, val_options
from test_torch_data import dataset_pair, write_coco_fixture
from test_torch_eval import (AP_TOL, _jax_loader, _port_loader,
                             _write_gt_from, assert_stats_close)
from test_torch_loop import read_log
from vitpose_tpu_torch.api import init_pose_model
from vitpose_tpu_torch.eval.loop import run_validation
from vitpose_tpu_torch.models.topdown import GenericMultiStageTopDown
from vitpose_tpu_torch.tools import test as cli
from vitpose_tpu_torch.tools import train as train_cli
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils import config
from test_torch_threads import torch_test_threads  # noqa: F401

# the train steps' models: tests/test_torch_cnn_ms.py's, cut to two units
# (MSPN), two stages of three branches (Lite-HRNet) and two stages on 16x16
# crops (CPM, 2x2 maps): JAX's differentiated train step of the module
# tests' models takes 20 s or more to trace and compile each, and its f64
# convs run in XLA's loops
TRAIN_CASES = {
    'mspn': dict(num_units=2, backbone_overrides=dict(num_units=2,
                                                      num_blocks=(1, 1))),
    'litehrnet': dict(backbone_overrides=dict(
        num_modules=(1, 1), num_blocks=(1, 1), reduce_ratios=(8, 8),
        stage_channels=((8, 16), (8, 16, 32)))),
    'cpm': dict(num_stages=2, img_size=(16, 16),
                backbone_overrides=dict(num_stages=2)),
}
# JAX's steps in float64 (jax_train_steps(f64=True)): MSPN's second-step
# grad_norm in f32 lies 1.9e-4 from the port's (Adam's first step turns
# f32 noise into +-lr); CPM's f32 gradients of its first stem convs lose
# digits in both packages (the port's up to 1.4% of a tensor's largest
# value from an f64 run, BN over 2 crops behind six 9x9 convs), so the
# port's CPM step runs in float64 too (within 1e-7 of JAX's f64)
F64_STEPS = ('mspn', 'cpm')
PORT_F64 = ('cpm',)
OPTIM = dict(TRAIN_OPTIM, base_lr=1e-5)
TRAIN_SEED = 20

MSPN = os.path.join(COCO_CFG, 'mspn50_coco_256x192.py')
MSPN_OPTIONS = [
    'model.img_size=(64, 48)', 'model.dtype=float32',
    'model.backbone_overrides.dtype=float32',
    'model.backbone_overrides.num_blocks=(1, 1, 1, 1)',
    'model.backbone_overrides.unit_channels=16',
    'model.backbone_overrides.res_top_channels=16',
    'data.image_size=(48, 64)', 'data.heatmap_size=(12, 16)',
    'data.batch_size=4', 'data.num_workers=2']
RSN3 = os.path.join(COCO_CFG, '3xrsn50_coco_256x192.py')
RSN3_OPTIONS = [
    'model.img_size=(64, 48)', 'model.dtype=float32', 'model.num_units=2',
    'model.backbone_overrides.dtype=float32',
    'model.backbone_overrides.num_units=2',
    'model.backbone_overrides.num_blocks=(1, 1)',
    'model.backbone_overrides.unit_channels=16',
    'data.image_size=(48, 64)', 'data.heatmap_size=(12, 16)',
    'data.batch_size=4', 'data.num_workers=0', 'runtime.log_interval=1',
    'runtime.eval_interval=10', 'runtime.ckpt_interval=1']


@pytest.mark.parametrize('name', TRAIN_CASES)
def test_train_steps_match_jax(name):
    """Two steps: every (stage, unit) map's joints MSE summed, metrics, the
    gradients as Adam's first moment, and every parameter and BN statistic
    after each step."""
    mdict = dict(model_dict(name), **TRAIN_CASES[name])
    mdict['backbone_overrides'] = dict(
        model_dict(name)['backbone_overrides'],
        **TRAIN_CASES[name]['backbone_overrides'])
    v = jax_variables(mdict, seed=TRAIN_SEED)
    model = port_model(mdict, v)
    batch = train_batch(model, mdict['img_size'], seed=30 + TRAIN_SEED)
    ref = jax_train_steps(mdict, v, batch, OPTIM, f64=name in F64_STEPS)
    if name in PORT_F64:
        twin = build_model_from_cfg(dict(
            mdict, dtype='float64', backbone_overrides=dict(
                mdict['backbone_overrides'], dtype='float64'))).double()
        twin.load_state_dict(model.state_dict())
        model = twin
    assert_train_steps_match(model, batch, ref, mdict['backbone_type'],
                             optim=OPTIM)


def test_eval_cli_on_mspn_config_matches_jax(tmp_path):
    """tools/test.py main() on the MSPN-50 zoo config (cut by
    --cfg-options) and an .npz of JAX variables writes the stats of JAX's
    run_validation + evaluate on them, with the 'megvii' decode."""
    coco = write_coco_fixture(str(tmp_path / 'val'), seed=3)
    jcfg = jax_apply_options(jax_load_config(MSPN), MSPN_OPTIONS)
    assert jcfg['model']['post_process'] == 'megvii'
    v = jax_variables(jcfg['model'], seed=40)
    from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
    jm = jax_build(jcfg['model'])
    npz = str(tmp_path / 'mspn.npz')
    save_params_npz(npz, v)
    pm = init_pose_model(config.apply_options(config.load_config(MSPN),
                                              MSPN_OPTIONS)['model'], npz,
                         device='cpu')
    cfg = pm.cfg
    assert isinstance(pm.model, GenericMultiStageTopDown) \
        and cfg.post_process == 'megvii' and cfg.modulate_kernel == 5
    kw = dict(use_udp=cfg.use_udp, post_process=cfg.post_process,
              modulate_kernel=cfg.modulate_kernel)
    _write_gt_from(run_validation(pm.model, _port_loader(coco), **kw), coco,
                   seed=4)
    ref = jax_run_validation(jm, jax.tree.map(np.asarray, v),
                             _jax_loader(coco), **kw)
    out = str(tmp_path / 'stats.json')
    stats = cli.main([MSPN, npz, '--out', out, '--device', 'cpu',
                      '--cfg-options', *MSPN_OPTIONS, *val_options(coco)])
    ref_ds, _ = dataset_pair(coco, test_mode=True, use_gt_bbox=False,
                             bbox_file=coco['det'])
    with open(out) as f:
        written = json.load(f)
    assert_stats_close(written, ref_ds.evaluate(ref), AP_TOL)
    assert written == {k: float(v) for k, v in stats.items()}
    assert 0 < written['AP'] < 1


def test_train_cli_on_rsn_config_resumes_bit_for_bit(tmp_path):
    """The training CLI on the 3xRSN-50 zoo config (three stages of two
    units, cut): finite losses over two epochs of two steps, the epoch
    checkpoints written, and one epoch, then --resume, equal to two epochs
    at once in every tensor and logged loss."""
    coco = write_coco_fixture(str(tmp_path / 'data'), seed=5)
    options = [*RSN3_OPTIONS, f"data.train.ann_file={coco['ann']}",
               f"data.train.img_prefix={coco['prefix']}",
               *val_options(coco)]
    common = ['--device', 'cpu', '--cfg-options', *options]
    whole = train_cli.main([RSN3, '--work-dir', str(tmp_path / 'whole'),
                            *common, 'optimizer.total_epochs=2'])
    assert isinstance(whole.model, GenericMultiStageTopDown)
    cut = str(tmp_path / 'cut')
    train_cli.main([RSN3, '--work-dir', cut, *common,
                    'optimizer.total_epochs=1'])
    resumed = train_cli.main([RSN3, '--work-dir', cut, '--resume', *common,
                              'optimizer.total_epochs=2'])
    assert whole.step == resumed.step > 2
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    logs = [[r for r in read_log(d) if r.get('mode') == 'train']
            for d in (str(tmp_path / 'whole'), cut)]
    assert all(np.isfinite(r['heatmap_loss']) for r in logs[0])
    assert [r['heatmap_loss'] for r in logs[0] if r['epoch'] == 1] == \
        [r['heatmap_loss'] for r in logs[1] if r['epoch'] == 1]
    assert os.path.exists(os.path.join(cut, 'ckpts', 'epoch_1.pth'))


@pytest.mark.parametrize('saved_prm', [True, False])
def test_checkpoint_without_the_configs_prm_is_refused_as_jax_does(
        tmp_path, saved_prm):
    """A .pth whose MSMU head has the Pose Refine Machine loads only into
    a model whose config sets use_prm, and the other way round, with JAX's
    messages (convert_msmu_head)."""
    saved = dict(model_dict('rsn'), dataset='coco', use_prm=saved_prm)
    path = str(tmp_path / 'rsn.pth')
    torch.save({'state_dict': init_pose_model(saved, device='cpu')
                .model.state_dict()}, path)
    assert init_pose_model(saved, path, device='cpu').cfg.use_prm \
        == saved_prm
    other = dict(saved, use_prm=not saved_prm)
    with pytest.raises(ValueError, match='use_prm=True' if saved_prm
                       else 'carries no predict_layers'):
        init_pose_model(other, path, device='cpu')
