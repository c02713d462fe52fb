"""The entry points on item 12a's backbones against the JAX package on the
CPU: two training steps of ViPNAS-ResNet and of ResNeSt, the evaluation CLI
on the zoo's ViPNAS-MobileNetV3 config, and the strict load of a checkpoint
that does not name a flax-named backbone's modules.

  * Train steps: the tiny models of tests/test_torch_cnn_more.py (ViPNAS-
    ResNet with one block per stage, its context blocks, grouped convs and
    the grouped-deconv head; ResNeSt at depth 18's stage counts with its
    split attention), JAX variables from a seeded numpy generator carried
    through `cnn_state_dict_from_flax`, 2 crops, MSRA targets, lr 1e-5
    (ViPNAS-ResNet at weight decay 10; see OPTIMS), held as
    tests/test_torch_cnn.py holds HRNetV2's (`assert_train_steps_match`:
    metrics 1e-4 relative; Adam's first moment after step 1; BN statistics
    1e-4 relative plus 1e-5 absolute; parameters PARAM_TOL but for at most
    FLIPPED_SHARE of the elements, each within the steps' lr), ResNeSt's
    attention fc2 kernels at a tenth of the fan-in scale (see
    SPLAT_FC2_SCALE). JAX's ResNeSt steps run in float64
    (`jax_train_steps(f64=True)`): its f32 statistics, summed by XLA's CPU
    reductions, lose more of ResNeSt's gradients than the port's f32 does
    (beyond these tolerances).
  * Evaluation: the zoo's `vipnas_mbv3_coco_256x192.py` cut by
    --cfg-options (one block per stage, 64x48 crops: 2x2 features, three
    grouped deconvs of 16 in 4 groups), f32, the 'default' decode with the
    config's shift_heatmap, on the COCO fixture of tests/test_torch_data.py
    (10 detections, batches of 4); the GT rewritten from the port's
    predictions so that AP lies strictly between 0 and 1; the CLI reads an
    .npz of the JAX variables, which JAX's run_validation + evaluate run on,
    held to 1e-6 as tests/test_torch_cnn_paths.py holds HRNet's.
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

from test_torch_cnn import (TRAIN_OPTIM, assert_train_steps_match,
                            jax_train_steps)
from test_torch_cnn_more import (jax_variables, model_dict,  # noqa: F401
                                 one_torch_thread, port_model)
from test_torch_cnn_paths import COCO_CFG, val_options
from test_torch_data import dataset_pair, write_coco_fixture
from test_torch_eval import (AP_TOL, _jax_loader, _port_loader,
                             _write_gt_from, assert_stats_close)
from vitpose_tpu_torch.api import init_pose_model
from vitpose_tpu_torch.eval.loop import run_validation
from vitpose_tpu_torch.ops import target as ttarget
from vitpose_tpu_torch.tools import test as cli
from vitpose_tpu_torch.utils import config
from test_torch_threads import torch_test_threads  # noqa: F401

MBV3 = os.path.join(COCO_CFG, 'vipnas_mbv3_coco_256x192.py')
MBV3_OPTIONS = [
    'model.img_size=(64, 48)',
    'model.backbone_overrides.dep=(0, 1, 1, 1, 1, 1, 1)',
    'model.deconv_filters=(16, 16, 16)', 'model.deconv_groups=(4, 4, 4)',
    'data.image_size=(48, 64)', 'data.heatmap_size=(12, 16)',
    'data.batch_size=4', 'data.num_workers=2']
TRAIN_CASES = ('vipnas_resnet', 'resnest')
# lr 1e-5: at tests/test_torch_cnn.py's 1e-3, Adam's first step moves every
# element by about lr whatever its gradient, and ResNeSt's second-step
# grad_norm lies 6.4e-4 apart between JAX's own f32 and f64 runs (the port's
# f32 8e-4 from that f64 run); at 1e-5 the steps stay comparable.
# ViPNAS-ResNet at weight decay 10: the decay's share of the two steps,
# lr * wd * |p| (6.5e-5 at |p| = 1), is then 5 times the steps' lr that
# bounds every parameter's distance from JAX's, so a leaf that one side
# decays and the other does not (a BN or LayerNorm scale, a kernel) fails
# the check. ResNeSt keeps the default 0.1: at a decay of 1 or more its
# second-step grad_norm in f32 moves off the f64 one, JAX's own by 1.2e-4
# and the port's by 1.8e-4 (the metrics are held to 1e-4); its decayed set
# is held by tests/test_torch_cnn_more.py's
# test_weight_decay_and_lr_scale_sets_match_jax
OPTIMS = {'vipnas_resnet': dict(TRAIN_OPTIM, base_lr=1e-5, weight_decay=10.0),
          'resnest': dict(TRAIN_OPTIM, base_lr=1e-5)}
# ResNeSt's split attention adds, through its global average pool, one
# constant per channel to the gradient of each splat BN's output; fc2
# kernels at the fan-in scale make that constant 1e2-1e3 times the rest
# and every BN's backward cancels it, so f32 loses part of layer1's
# gradients in both packages (in f64 the two agree). A tenth of that scale
# keeps the cancellation inside f32's digits
SPLAT_FC2_SCALE = np.float32(0.1)
TRAIN_SEED = 20


# --- training ----------------------------------------------------------------

def train_batch(model, hw, seed):
    """2 seeded crops of `hw` and MSRA targets at the model's heatmap
    size."""
    with torch.no_grad():
        hm_h, hm_w = model(torch.zeros(1, *hw, 3)).shape[2:]
    h, w = hw
    rng = np.random.RandomState(seed)
    imgs = rng.randn(2, h, w, 3).astype(np.float32)
    joints = rng.uniform(0, w, (2, 17, 2)).astype(np.float32)
    vis = (rng.rand(2, 17) > 0.2).astype(np.float32)
    target, weight = ttarget.generate_msra_heatmaps(
        torch.from_numpy(joints), torch.from_numpy(vis), (w, h),
        (hm_w, hm_h), sigma=2.0)
    return {'imgs': imgs, 'target': target.numpy(),
            'target_weight': weight.numpy()}


def train_variables(mdict, seed):
    """JAX variables of `mdict` from `seed`, ResNeSt's split-attention fc2
    kernels scaled by SPLAT_FC2_SCALE."""
    _, v = jax_variables(mdict, seed)
    for block in v['params']['backbone'].values():
        if 'splat' in block:
            block['splat']['fc2']['kernel'] *= SPLAT_FC2_SCALE
    return v


@pytest.mark.parametrize('name', TRAIN_CASES)
def test_train_steps_match_jax(name):
    mdict = model_dict(name)
    v = train_variables(mdict, seed=TRAIN_SEED)
    model = port_model(mdict, v)
    batch = train_batch(model, mdict['img_size'], seed=30 + TRAIN_SEED)
    ref = jax_train_steps(mdict, v, batch, OPTIMS[name],
                          f64=name == 'resnest')
    assert_train_steps_match(model, batch, ref, mdict['backbone_type'],
                             optim=OPTIMS[name])


# --- evaluation --------------------------------------------------------------

def test_eval_cli_on_vipnas_mbv3_config_matches_jax(tmp_path):
    """tools/test.py main() on the ViPNAS-MobileNetV3 zoo config (cut by
    --cfg-options) and an .npz of JAX variables writes the stats of JAX's
    run_validation + evaluate on them."""
    coco = write_coco_fixture(str(tmp_path / 'val'), seed=3)
    jcfg = jax_apply_options(jax_load_config(MBV3), MBV3_OPTIONS)
    jm, v = jax_variables(jcfg['model'], seed=40)
    npz = str(tmp_path / 'vipnas_mbv3.npz')
    save_params_npz(npz, v)
    pm = init_pose_model(config.apply_options(config.load_config(MBV3),
                                              MBV3_OPTIONS)['model'], npz,
                         device='cpu')
    cfg = pm.cfg
    assert pm.model.backbone_type == 'vipnas_mbv3' and cfg.deconv_groups \
        == (4, 4, 4) and pm.image_size == (48, 64)
    _write_gt_from(run_validation(pm.model, _port_loader(coco),
                                  use_udp=cfg.use_udp,
                                  post_process=cfg.post_process), coco,
                   seed=4)
    ref = jax_run_validation(jm, jax.tree.map(np.asarray, v),
                             _jax_loader(coco), use_udp=jm.cfg.use_udp,
                             post_process=jm.cfg.post_process)
    out = str(tmp_path / 'stats.json')
    stats = cli.main([MBV3, npz, '--out', out, '--device', 'cpu',
                      '--cfg-options', *MBV3_OPTIONS, *val_options(coco)])
    ref_ds, _ = dataset_pair(coco, test_mode=True, use_gt_bbox=False,
                             bbox_file=coco['det'])
    with open(out) as f:
        written = json.load(f)
    assert_stats_close(written, ref_ds.evaluate(ref), AP_TOL)
    assert written == {k: float(v) for k, v in stats.items()}
    assert 0 < written['AP'] < 1


# --- checkpoints -------------------------------------------------------------

def test_strict_load_says_why_a_flax_named_backbone_refuses(tmp_path):
    """A .pth whose names are not the port's (as a reference mmpose .pth of
    ResNeSt is not: the JAX package has no converter for it) fails the
    strict load with the reason; the port's own .pth loads."""
    mdict = dict(model_dict('resnest'), dataset='coco')
    model = init_pose_model(mdict, device='cpu').model
    sd = model.state_dict()
    own = str(tmp_path / 'own.pth')
    torch.save({'state_dict': sd}, own)
    assert init_pose_model(mdict, own, device='cpu').model.backbone_type \
        == 'resnest'
    # mmpose's ResNeSt names its split attention `conv2` (fc1 and fc2
    # inside it), where JAX's block has `splat`
    renamed = {k.replace('.splat.', '.conv2.'): v for k, v in sd.items()}
    ref = str(tmp_path / 'mmpose.pth')
    torch.save({'state_dict': renamed}, ref)
    with pytest.raises(RuntimeError, match="flax paths.*mmpose .pth does "
                       'not load'):
        init_pose_model(mdict, ref, device='cpu')
