"""The port's bottom-up entry points against the JAX package on the CPU: the
evaluation CLI, the training CLI's runner (and its resume), init_pose_model
with a .pth and an .npz, the three bottom-up demos, and every bottom-up
config of the zoo through the port's model factories and refusals.

  * Evaluation: the flagship HigherHRNet-W32 config cut by --cfg-options to
    HRNet of width 8 (one module per stage, one block per branch) at a 64
    input, on four seeded 64x64 JPEGs. The port's weights (BN redrawn,
    heatmap biases shifted so that at most a few peaks per joint pass the
    parser's threshold in each image) go to JAX through its converter and
    into one .npz, which
    both CLIs read. The GT people are the port's own predictions, jittered
    and some dropped, beside a crowd region in compressed RLE and one in
    polygons, so that AP lies strictly between 0 and 1; JAX's
    run_bottomup_eval (tools/test.py, imported by path; its model's apply
    compiled at XLA level 0) gives the reference stats, held to 1e-6.
  * Runner: the same cut config with a 64 input, output sizes (16, 32),
    batch 2 over four images (one epoch of two steps), lr 1e-5 (see
    tests/test_torch_bottomup.py: LR), both runners from the same weights
    (JAX's init replaced by the converted port weights, its jitted step
    compiled at level 0): logged losses 1e-4 relative plus 1e-7 absolute
    (TAG_LOSS_ATOL), BN statistics 1e-4
    relative plus 1e-5 absolute, parameters 1e-4 relative plus 5e-5
    absolute but for at most FLIPPED_SHARE of the elements. The loaders
    take the same draws (their rotated affine matrices may differ by one
    f32 ulp, see the module tests). Resume: one epoch, then --resume for the
    second, equals two uninterrupted epochs bit for bit.
  * Zoo: all 44 configs (HRNet, ResNet and, since item 12b, MobileNetV2
    and Hourglass-AE with its multi-stage head) pass the refusals of the
    runner and of the evaluation CLI and build at full width on the meta
    device, their state-dict keys exactly those JAX's converters read; a
    refused config would raise NotImplementedError naming its backbone or
    head in build_model_from_cfg, init_pose_model, the evaluation CLI and
    the training CLI.
"""
import functools
import glob
import importlib.util
import json
import os
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.models.bottomup import BottomUpEstimator as JaxEstimator
from vitpose_tpu.train import bottomup_loop as jax_bottomup_loop
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.cnn_ckpt import (BACKBONE_CONVERTERS,
                                        convert_ae_higher_head,
                                        convert_hourglass_ae)
from vitpose_tpu.utils.config import apply_options as jax_apply_options
from vitpose_tpu.utils.config import load_config as jax_load_config
from vitpose_tpu.utils.family_ckpt import (_convert_ae_multi_head,
                                           convert_bottomup_checkpoint)
from vitpose_tpu.utils.torch_ckpt import convert_head

from test_torch_bottomup import (BN_TOL, FLIPPED_SHARE, PARAM_TOL,
                                 shift_heatmap_bias)
from test_torch_cnn import randomize_bn
from test_torch_data import ROOT
from test_torch_eval import AP_TOL
from vitpose_tpu_torch.api import init_pose_model
from vitpose_tpu_torch.api.inference import (inference_bottom_up_multi_scale,
                                             multi_scale_maps)
from vitpose_tpu_torch.data.mask import encode_compressed_rle, mask_to_rle
from vitpose_tpu_torch.demo import (bottom_up_img_demo,
                                    bottom_up_pose_tracking_demo,
                                    bottom_up_video_demo)
from vitpose_tpu_torch.models.bottomup import BottomUpEstimator
from vitpose_tpu_torch.tools import test as cli
from vitpose_tpu_torch.tools import train as train_cli
from vitpose_tpu_torch.train import loop
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils import config
from vitpose_tpu_torch.utils.convert import bottomup_state_dict_from_flax
from vitpose_tpu_torch.utils.video import video_writer
from test_torch_threads import torch_test_threads  # noqa: F401

CFG_DIR = os.path.join(ROOT, 'vitpose_tpu', 'configs')
HIGHER = os.path.join(CFG_DIR, 'coco', 'higherhrnet_w32_coco_512x512.py')
SMALL = ['model.backbone_overrides.width=8',
         'model.backbone_overrides.stage_modules=(1, 1, 1)',
         'model.backbone_overrides.stage_blocks=1',
         'model.head_overrides.deconv_filters=(8,)',
         'model.head_overrides.num_basic_blocks=2',
         'data.input_size=64', 'data.base_size=64',
         'data.output_sizes=(16, 32)', 'data.batch_size=2',
         'optimizer.base_lr=1e-5', 'runtime.log_interval=1']
METRIC_RTOL = 1e-4
# the push and pull losses are 0.001 of the tag loss, about 1e-4 here: after
# Adam's first step (see FLIPPED_SHARE) their second-step values differ by
# up to 1.6e-8 (measured), 1.8e-4 of themselves
TAG_LOSS_ATOL = 1e-7


def cut_config(options):
    return config.apply_options(config.load_config(HIGHER), SMALL + options)


def write_images(root, n=4, seed=0, hw=(48, 72)):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    images = []
    for i in range(n):
        name = f'{i + 1:06d}.jpg'
        cv2.imwrite(os.path.join(root, name), rng.randint(
            0, 256, hw + (3,)).astype(np.uint8))
        images.append(dict(id=i + 1, file_name=name, width=hw[1],
                           height=hw[0]))
    return images


def crowd_regions(image_id, h, w, first_id):
    """One crowd region in compressed RLE and one in polygons."""
    m = np.zeros((h, w), np.uint8)
    m[2:12, 3:20] = 1
    rle = dict(counts=encode_compressed_rle(mask_to_rle(m)['counts']),
               size=[h, w])
    base = dict(image_id=image_id, category_id=1, iscrowd=1,
                keypoints=[0] * 51, num_keypoints=0)
    return [dict(base, id=first_id, bbox=[3, 2, 17, 10], area=170.0,
                 segmentation=rle),
            dict(base, id=first_id + 1, bbox=[40, 30, 12, 12], area=144.0,
                 segmentation=[[40, 30, 52, 30, 52, 42, 40, 42]])]


def write_annotations(path, images, people):
    """people: {image_id: [[17, 3] keypoints]} -> a COCO keypoint json."""
    anns = []
    for img in images:
        for kp in people.get(img['id'], []):
            kp = np.asarray(kp, np.float64)
            x0, y0 = kp[:, :2].min(0)
            x1, y1 = kp[:, :2].max(0)
            anns.append(dict(
                id=len(anns) + 1, image_id=img['id'], category_id=1,
                iscrowd=0, bbox=[x0, y0, x1 - x0, y1 - y0],
                area=float(max((x1 - x0) * (y1 - y0), 1.0)),
                keypoints=kp.ravel().tolist(),
                num_keypoints=int((kp[:, 2] > 0).sum())))
        anns += crowd_regions(img['id'], img['height'], img['width'],
                              len(anns) + 1)
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), f)
    return path


def seeded_model(cfg, seed):
    model = build_model_from_cfg(cfg['model'],
                                 torch.Generator().manual_seed(seed))
    return randomize_bn(model, seed + 100).eval()


def jax_variables(model, cfg):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return convert_bottomup_checkpoint(sd, cfg)


_APPLY = {}


def _compiled_apply(self, variables, imgs, train=False, mutable=False):
    """JAX's BottomUpEstimator.apply in eval mode as one program per input
    shape, compiled at level 0."""
    key = (id(self), imgs.shape)
    if key not in _APPLY:
        _APPLY[key] = jax.jit(_eager_apply, static_argnums=0).lower(
            self, variables, imgs).compile(
                compiler_options={'xla_backend_optimization_level': 0})
    return _APPLY[key](variables, imgs)


_eager_apply = JaxEstimator.apply


def jax_tools_test():
    spec = importlib.util.spec_from_file_location(
        '_jax_tools_test', os.path.join(ROOT, 'tools', 'test.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- evaluation ----------------------------------------------------------------

@pytest.fixture(scope='module')
def eval_set(tmp_path_factory):
    """(options, .npz path, port stats, JAX stats) of both CLIs."""
    root = tmp_path_factory.mktemp('bu_eval')
    prefix = str(root / 'img')
    # at the base size, so that the multi-scale warp pads nothing: a padded
    # band gives the maps plateaus, whose pixels NMS keeps as candidates of
    # (nearly) equal values and tags, where grouping follows the last bit
    images = write_images(prefix, seed=1, hw=(64, 64))
    ann = str(root / 'ann.json')
    cfg = cut_config([])
    model = seeded_model(cfg, 7)
    shift_heatmap_bias(model, torch.cat([multi_scale_maps(
        model, os.path.join(prefix, img['file_name']), base_size=64)[0]
        for img in images]))
    rng = np.random.RandomState(2)
    people = {}
    for img in images:
        preds, _ = inference_bottom_up_multi_scale(
            model, os.path.join(prefix, img['file_name']), base_size=64,
            pose_nms_thr=None)
        kept = []
        for p in preds[:4]:
            kp = p['keypoints'].astype(np.float64)
            kp[:, :2] += rng.normal(0, 1.5, (17, 2))
            kp[:, 2] = np.where(rng.rand(17) < 0.8, 2, 0)
            kept.append(kp)
        people[img['id']] = kept
    write_annotations(ann, images, people)
    npz = str(root / 'weights.npz')
    save_params_npz(npz, jax_variables(model, cfg))
    options = [f'data.val.ann_file={ann}', f'data.val.img_prefix={prefix}/']
    out = str(root / 'stats.json')
    stats = cli.main([HIGHER, npz, '--device', 'cpu', '--out', out,
                      '--cfg-options', *SMALL, *options])
    with open(out) as f:
        assert json.load(f) == {k: float(v) for k, v in stats.items()}
    jcfg = jax_apply_options(jax_load_config(HIGHER), SMALL + options)
    jout = str(root / 'jax_stats.json')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxEstimator, 'apply', _compiled_apply)
        jax_tools_test().run_bottomup_eval(jcfg, types.SimpleNamespace(
            checkpoint=npz, metric=None, out=jout))
    with open(jout) as f:
        jstats = json.load(f)
    return options, npz, model, stats, jstats


def test_eval_cli_on_flagship_config_matches_jax(eval_set):
    _, _, _, stats, jstats = eval_set
    assert 0 < stats['AP'] < 1
    assert sorted(stats) == sorted(jstats)
    for key, value in jstats.items():
        assert abs(stats[key] - value) <= AP_TOL, key


@pytest.mark.parametrize('flag', [['--int8'], ['--show-dir', 'x'],
                                  ['--batch-size', '4']])
def test_eval_cli_refuses_options_bottom_up_does_not_read(eval_set, flag):
    options, npz, _, _, _ = eval_set
    with pytest.raises(NotImplementedError, match=flag[0]):
        cli.main([HIGHER, npz, '--device', 'cpu', *flag, '--cfg-options',
                  *SMALL, *options])


@pytest.mark.parametrize('kind', ['pth', 'npz'])
def test_init_pose_model_loads_bottom_up_checkpoints(eval_set, tmp_path,
                                                     kind):
    """A .pth under the mmpose names (in a {'state_dict'} container with
    the 'module.' prefix, as released checkpoints come) and JAX's .npz load
    strictly and give the source model's maps exactly."""
    _, npz, model, _, _ = eval_set
    path = npz
    if kind == 'pth':
        path = str(tmp_path / 'w.pth')
        torch.save({'state_dict': {f'module.{k}': v for k, v in
                                   model.state_dict().items()}}, path)
    mdict = cut_config([])['model']
    est = init_pose_model(mdict, checkpoint=path, device='cpu')
    assert isinstance(est, BottomUpEstimator) and not est.training
    x = torch.from_numpy(np.random.RandomState(3).randn(
        1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(est(x), model(x)):
            assert torch.equal(a, b)


# --- the runner ----------------------------------------------------------------

def _replace_init(variables):
    def init(self, rng, sample):
        return jax.tree.map(jnp.asarray, variables)
    return init


def _level0_step(step_fn, mesh, n_args, batch_argnums, donate_argnums=()):
    """data_parallel_step on one device, compiled at level 0."""
    cache = {}

    def run(*args):
        if 'fn' not in cache:
            cache['fn'] = jax.jit(step_fn).lower(*args).compile(
                compiler_options={'xla_backend_optimization_level': 0})
        return cache['fn'](*args)
    return run, lambda batch: jax.tree.map(jnp.asarray, batch)


def read_log(work_dir, mode='train'):
    with open(os.path.join(work_dir, 'train.log.json')) as f:
        return [r for r in map(json.loads, f) if r['mode'] == mode]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('bu_train')
    prefix = str(root / 'img')
    images = write_images(prefix, seed=4)
    rng = np.random.RandomState(5)
    people = {img['id']: [np.concatenate([
        rng.uniform(0, 70, (17, 2)), rng.randint(0, 3, (17, 1))], 1)
        for _ in range(2)] for img in images}
    ann = write_annotations(str(root / 'ann.json'), images, people)
    options = [f'data.train.ann_file={ann}',
               f'data.train.img_prefix={prefix}/',
               'optimizer.total_epochs=1']
    cfg = cut_config(options)
    model = seeded_model(cfg, 9)
    variables = jax_variables(model, cfg)
    jcfg = jax_apply_options(jax_load_config(HIGHER), SMALL + options)
    jdir = str(root / 'jax')
    from vitpose_tpu.parallel import mesh as jax_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxEstimator, 'init', _replace_init(variables))
        mp.setattr(jax_mesh, 'data_parallel_step', _level0_step)
        jvars = jax_bottomup_loop.train_bottomup_model(jcfg, work_dir=jdir)
    jsd = bottomup_state_dict_from_flax(jax.tree.map(np.asarray, jvars),
                                        'hrnet')
    pdir = str(root / 'port')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, 'build_model_from_cfg',
                   lambda mcfg, generator=None: model)
        state = loop.train_model(cfg, work_dir=pdir, device='cpu')
    # resume: one epoch, then --resume for the second, against two at once
    two = ['optimizer.total_epochs=2']
    whole = train_cli.main([HIGHER, '--work-dir', str(root / 'whole'),
                            '--device', 'cpu', '--cfg-options', *SMALL,
                            *options, *two])
    cut = str(root / 'cut')
    train_cli.main([HIGHER, '--work-dir', cut, '--device', 'cpu',
                    '--cfg-options', *SMALL, *options])
    resumed = train_cli.main([HIGHER, '--work-dir', cut, '--device', 'cpu',
                              '--resume', '--cfg-options', *SMALL, *options,
                              *two])
    return (read_log(jdir), jsd, read_log(pdir), state, whole, resumed,
            str(root / 'whole'), cut)


def test_runner_on_flagship_config_matches_jax(runs):
    jlog, jsd, log, state, _, _, _, _ = runs
    assert [r['step'] for r in log] == [r['step'] for r in jlog] == [1, 2]
    for r, jr in zip(log, jlog):
        for key in ('heatmap_loss', 'push_loss', 'pull_loss', 'total_loss'):
            np.testing.assert_allclose(r[key], jr[key], rtol=METRIC_RTOL,
                                       atol=TAG_LOSS_ATOL,
                                       err_msg=f"step {r['step']} {key}")
        assert 0 <= r['data_time'] <= r['time']
    flipped = total = 0
    for key, value in state.model.state_dict().items():
        if 'num_batches' in key:
            continue
        got, want = value.numpy(), jsd[key].numpy()
        if 'running' in key:
            np.testing.assert_allclose(got, want, **BN_TOL, err_msg=key)
            continue
        flipped += int((np.abs(got - want) > PARAM_TOL['atol']
                        + PARAM_TOL['rtol'] * np.abs(want)).sum())
        total += got.size
    assert flipped <= FLIPPED_SHARE * total


def test_resume_equals_the_uninterrupted_run(runs):
    _, _, _, _, whole, resumed, whole_dir, cut_dir = runs
    assert whole.step == resumed.step == 4
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    second = [[r for r in read_log(d) if r['epoch'] == 1]
              for d in (whole_dir, cut_dir)]
    assert [r['step'] for r in second[0]] == [r['step'] for r in second[1]] \
        == [3, 4]
    for r, r2 in zip(*second):
        for key in ('heatmap_loss', 'push_loss', 'pull_loss', 'total_loss',
                    'grad_norm'):
            assert r[key] == r2[key], key
    assert read_log(cut_dir, 'resume') == [{'mode': 'resume', 'epoch': 1}]
    assert os.path.exists(os.path.join(cut_dir, 'ckpts', 'epoch_1.pth'))


# --- demos -------------------------------------------------------------------

def test_bottom_up_demos_on_the_cpu(tmp_path):
    img = np.random.RandomState(6).randint(0, 256, (40, 56, 3)).astype(
        np.uint8)
    path = str(tmp_path / 'frame.jpg')
    cv2.imwrite(path, img)
    video = str(tmp_path / 'clip.avi')
    writer = video_writer(video, 10, (56, 40))
    for i in range(3):
        writer.write(np.roll(img, 2 * i, axis=1))
    writer.release()
    common = ['--base-size', '64', '--device', 'cpu']
    results, out = bottom_up_img_demo.main(
        [path, '--out-img-root', str(tmp_path / 'img'), *common])
    assert os.path.exists(out)
    assert all(r['keypoints'].shape == (17, 3) and 'area' in r
               for r in results)
    for demo, prefix in ((bottom_up_video_demo, 'bu_'),
                         (bottom_up_pose_tracking_demo, 'bu_track_')):
        n, out = demo.main([video, '--out-video-root', str(tmp_path / 'v'),
                            '--max-frames', '2', *common])
        assert n == 2 and os.path.basename(out) == prefix + 'clip.avi'
        cap = cv2.VideoCapture(out)
        assert cap.read()[0]
        cap.release()


# --- the zoo's bottom-up configs -----------------------------------------------

def _zoo_bottomup_configs():
    out = []
    for p in sorted(glob.glob(os.path.join(CFG_DIR, '*', '*.py'))):
        if config.load_config(p).get('model', {}).get('family') == \
                'bottomup':
            out.append(os.path.relpath(p, ROOT))
    return out


BOTTOMUP_CONFIGS = _zoo_bottomup_configs()
# the configs that wait for later items, with the name each refusal cites:
# none since item 12b (MobileNetV2 and Hourglass-AE)
REFUSED = {}
RUNNABLE = [p for p in BOTTOMUP_CONFIGS if p not in REFUSED]


@functools.lru_cache(maxsize=None)
def _meta_model(model_json):
    with torch.device('meta'):
        return build_model_from_cfg(json.loads(model_json))


class _Reads(dict):
    """A state dict that records the keys a converter reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if k in self:
            self.read.add(k)
        return super().get(k, default)


@functools.lru_cache(maxsize=None)
def _converter_reads(backbone_type, head, keys):
    """The keys JAX's convert_bottomup_checkpoint reads of a state dict
    with these keys (tiny arrays of each entry's rank stand in)."""
    sd = _Reads({k: np.zeros((1,) * nd, np.float32) for k, nd in keys})
    # JAX's registry has no hourglass_ae entry; its converter, at the
    # config's downsample_times 4
    converters = dict(BACKBONE_CONVERTERS, hourglass_ae=convert_hourglass_ae)
    converters[backbone_type](sd, prefix='backbone.')
    if head == 'ae_higher':
        convert_ae_higher_head(sd, prefix='keypoint_head.')
    elif head == 'ae_multi':
        _convert_ae_multi_head(sd, prefix='keypoint_head.')
    else:
        convert_head(sd, prefix='keypoint_head.')
    return frozenset(sd.read)


@pytest.mark.parametrize('path', RUNNABLE)
def test_bottom_up_config_passes_the_refusals_and_builds(path):
    cfg = config.load_config(os.path.join(ROOT, path))
    loop._refuse_unported(cfg)
    cli._refuse_unported(cfg, cli_args())
    mcfg = cfg['model']
    model = _meta_model(json.dumps(mcfg, sort_keys=True))
    assert isinstance(model, BottomUpEstimator)
    assert model.dataset_info.dataset_name == cfg['data']['dataset']
    assert model.num_joints == mcfg['num_joints'] \
        == model.dataset_info.num_joints
    sd = model.state_dict()
    keys = frozenset((k, v.ndim) for k, v in sd.items()
                     if not k.endswith('num_batches_tracked'))
    assert _converter_reads(mcfg['backbone_type'], mcfg['head'], keys) \
        == {k for k, _ in keys}
    assert model.parser.use_udp == bool((mcfg.get('parser') or {}).get(
        'use_udp', False))


def cli_args(**kw):
    return types.SimpleNamespace(**dict(dict(
        int8=False, show_dir=None, batch_size=None, tmpdir=None), **kw))


def test_the_zoo_has_41_runnable_and_3_refused_bottom_up_configs(tmp_path):
    """The counts since item 12b: all 44 bottom-up configs run (the name
    keeps the counts from before it)."""
    assert len(BOTTOMUP_CONFIGS) == 44 and len(RUNNABLE) == 44
    for path, name in REFUSED.items():
        full = os.path.join(ROOT, path)
        cfg = config.load_config(full)
        with pytest.raises(NotImplementedError, match=name):
            build_model_from_cfg(cfg['model'])
        with pytest.raises(NotImplementedError, match=name):
            init_pose_model(full, device='cpu')
        with pytest.raises(NotImplementedError, match=name):
            cli.main([full, 'none.pth', '--device', 'cpu'])
        with pytest.raises(NotImplementedError, match=name):
            train_cli.main([full, '--work-dir', str(tmp_path),
                            '--device', 'cpu'])
