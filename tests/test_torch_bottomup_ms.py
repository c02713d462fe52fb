"""The port's multi-stage and lightweight bottom-up models of ROADMAP item
12b against the JAX package on the CPU: Hourglass-AE with the multi-stage
AE head (parameterless, as the zoo's config sets it; the head with a
deconv and a prediction conv is held alone) and MobileNetV2 with the AE
simple head: every stack's
output and the flip inference, which keeps the last stage; the weight
converters both ways; the multi-scale API, which keeps only the last stage
where the port used to aggregate every one (the grouping of JAX's maps
held to JAX's); init_pose_model with an .npz;
and two training steps of Hourglass-AE, its loss over every stack (the
backbone in float64 on both sides, see `train_runs`).

Models: Hourglass-AE of two stacks at downsample_times 2, widths 16 to 32,
on 64x64 inputs (16x16 maps, 4x4 at the bottom); MobileNetV2 at a quarter
width with one deconv of 16.
Weights: JAX's init shapes, filled from a seeded numpy generator, through
`bottomup_state_dict_from_flax` with strict=True. Random weights give many
candidates per joint: the last stack's heatmap biases are shifted so that
a few local maxima per joint pass the parser's threshold. Each JAX forward
is one program compiled once per module.

Tolerances as tests/test_torch_bottomup.py: maps 1e-4 absolute plus 1e-4
relative, grouped poses 1e-3 px and their scores 1e-4 relative plus 1e-6
absolute, the converters exact, the train steps as its
test_two_train_steps_match_jax.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitpose_tpu.api.inference import (
    inference_bottom_up_multi_scale as jax_multi_scale)
from vitpose_tpu.models import bottomup as jbu
from vitpose_tpu.models.heads_extra import (
    AEMultiStageHead as JaxAEMultiStageHead)
from vitpose_tpu.train import bottomup_loop as jloop
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.cnn_ckpt import convert_hourglass_ae
from vitpose_tpu.utils.family_ckpt import (_convert_ae_multi_head, _vars,
                                           convert_bottomup_checkpoint)

from test_torch_bottomup import (BN_TOL, FLIP, FLIPPED_SHARE, LR,
                                 METRIC_RTOL, PARAM_TOL, POSE_TOL_PX, TOL,
                                 _adam_mu, _compiled_apply, recording_parse,
                                 train_batch)
from test_torch_models import _compile_fast, _fill
from vitpose_tpu_torch.api import inference, init_pose_model
from vitpose_tpu_torch.api.inference import multi_scale_maps
from vitpose_tpu_torch.models.bottomup import BottomUpEstimator
from vitpose_tpu_torch.models.heads_extra import AEMultiStageHead
from vitpose_tpu_torch.ops import group as pgroup
from vitpose_tpu_torch.train import bottomup_loop as ploop
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils.convert import bottomup_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

HG_AE = dict(downsample_times=2, num_stacks=2, out_channels=34,
             stage_channels=(16, 24, 32), feat_channels=16)
MODELS = {
    'hourglass_ae': dict(backbone_type='hourglass_ae',
                         backbone_overrides=HG_AE, head='ae_multi',
                         head_overrides=dict(
                             out_channels=34, num_stages=2,
                             num_deconv_layers=0, deconv_filters=(),
                             deconv_kernels=(), final_kernel=0)),
    'mobilenet_v2': dict(backbone_type='mobilenet_v2',
                         backbone_overrides=dict(widen_factor=0.25),
                         head='ae', head_overrides=dict(
                             tag_per_joint=True, deconv_filters=(16,),
                             deconv_kernels=(4,), final_kernel=1)),
}


def mdict(name):
    return dict(MODELS[name], family='bottomup', num_joints=17,
                dataset_info='coco')


def images(seed, n=2, hw=(64, 64)):
    return np.random.RandomState(seed).randn(n, *hw, 3).astype(np.float32)


def jax_variables(name, seed):
    """JAX's init shapes of `name`, filled from a seeded numpy generator."""
    est = jax_build(mdict(name))
    shapes = jax.eval_shape(est.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    return est, _fill(shapes, seed)


def port_model(name, variables):
    model = build_model_from_cfg(mdict(name))
    model.load_state_dict(bottomup_state_dict_from_flax(
        variables, MODELS[name]['backbone_type']), strict=True)
    return model.eval()


def last_heatmap_biases(model):
    """The bias of the convs that give the kept stage's heatmaps."""
    head = model.keypoint_head
    if isinstance(head, AEMultiStageHead):
        final = head.multi_final_layers[-1]
        return (final if final is not None
                else model.backbone.out_convs[-1].conv).bias
    return head.final_layer.bias


def shift_biases(model, variables, hm, keep=3):
    """Shift the kept stage's heatmap biases, in the port model and in the
    JAX variables, so that about `keep` local maxima per joint of the maps
    `hm` pass 0.1."""
    flat = pgroup.heatmap_nms(hm).flatten(2).sort(-1, descending=True)[0]
    shift = (0.1 - flat[..., keep - 1:keep + 1].mean(-1).amax(0)).numpy()
    with torch.no_grad():
        last_heatmap_biases(model)[:17] += torch.from_numpy(shift)
    variables = jax.tree.map(np.array, variables)
    if MODELS_OF[id(model)] == 'mobilenet_v2':
        leaf = variables['head']['params']['deconv_head']['final']
    else:
        leaf = variables['backbone']['params']['out_conv1_conv']
    leaf['bias'][:17] += shift
    return variables


MODELS_OF = {}


def jax_infer_and_apply(est, v, x):
    """JAX's `BottomUpEstimator.infer` body (the last stage of a multi-stage
    head, else the multi-resolution reduction; then the flip) and its raw
    outputs, as one function to compile."""
    def apply_reduced(vv, xx):
        out = est.apply(vv, xx)
        if isinstance(out, (list, tuple)):
            out = out[-1] if est._multi_stage else jbu.reduce_multires_output(
                out, est.num_joints, getattr(est.head, 'with_ae_loss', None))
        return out

    return (jbu.ae_forward_with_flip(apply_reduced, v, x, est.num_joints,
                                     FLIP), est.apply(v, x))


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def infer_refs():
    """{model: (port model, JAX estimator, JAX variables, images, JAX
    (heatmaps, tags) of its infer, JAX raw outputs NCHW)}."""
    out = {}
    for i, name in enumerate(MODELS):
        est, v = jax_variables(name, seed=i)
        model = port_model(name, v)
        MODELS_OF[id(model)] = name
        x = images(20 + i)
        (hm, tags), raw = _compile_fast(
            functools.partial(jax_infer_and_apply, est), v, jnp.asarray(x))
        raw = raw if isinstance(raw, (list, tuple)) else [raw]
        out[name] = (model, est, v, x, (np.asarray(hm), np.asarray(tags)),
                     [np.asarray(r).transpose(0, 3, 1, 2) for r in raw])
    return out


@pytest.mark.parametrize('name', list(MODELS))
def test_outputs_and_flip_inference_match_jax(infer_refs, name):
    """Every stack's output (MobileNetV2: its one output), and the flip
    inference on the last stage alone."""
    model, _, _, x, (hm_ref, tags_ref), raw_ref = infer_refs[name]
    assert model.multi_stage == name.startswith('hourglass')
    with torch.no_grad():
        raw = model(torch.from_numpy(x))
    assert [tuple(r.shape) for r in raw] == [r.shape for r in raw_ref]
    assert len(raw) == (2 if model.multi_stage else 1)
    for got, want in zip(raw, raw_ref):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    hm, tags = model.infer(torch.from_numpy(x), FLIP)
    np.testing.assert_allclose(hm.numpy(), hm_ref, **TOL)
    np.testing.assert_allclose(tags.numpy(), tags_ref, **TOL)


@pytest.mark.parametrize('name', list(MODELS))
def test_flax_tree_round_trips_through_both_converters(infer_refs, name):
    """JAX's variables -> bottomup_state_dict_from_flax -> the port (strict)
    -> JAX's convert_bottomup_checkpoint give back every leaf bit for bit;
    the zoo's Hourglass-AE head has none."""
    model, _, v, _, _, _ = infer_refs[name]
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    if name.startswith('hourglass'):
        # JAX's convert_bottomup_checkpoint has no hourglass_ae entry in its
        # registry: its converters for the backbone and the head, as that
        # function would pair them
        back = {'backbone': _vars(*convert_hourglass_ae(
                    sd, downsample_times=2, prefix='backbone.')),
                'head': _vars(*_convert_ae_multi_head(sd))}
    else:
        back = convert_bottomup_checkpoint(sd, {'model': mdict(name)})
    want = dict(jax.tree_util.tree_leaves_with_path(v))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=str(path))
    heads = [k for k in model.state_dict() if k.startswith('keypoint_head.')]
    assert bool(heads) == (name != 'hourglass_ae')


def test_multi_stage_head_with_layers_matches_jax():
    """AEMultiStageHead with a deconv and a prediction conv per stage (the
    zoo's config has neither): JAX's variables through
    bottomup_state_dict_from_flax, the maps of two stages in eval and in
    training mode (BN over the batch), and back through JAX's
    `_convert_ae_multi_head` exactly."""
    kw = dict(out_channels=34, num_stages=2, num_deconv_layers=1,
              deconv_filters=(16,), deconv_kernels=(4,), final_kernel=1)
    head = JaxAEMultiStageHead(**kw)
    rng = np.random.RandomState(7)
    feats = [rng.randn(2, 8, 8, 34).astype(np.float32) for _ in range(2)]
    v = _fill(jax.eval_shape(head.init, jax.random.PRNGKey(0), feats), 8)

    def fn(v, feats):
        return (head.apply(v, feats),
                head.apply(v, feats, train=True, mutable=['batch_stats'])[0])

    evals, trains = _compile_fast(fn, v, [jnp.asarray(f) for f in feats])
    port = AEMultiStageHead(34, **kw)
    sd = bottomup_state_dict_from_flax(
        {'backbone': {'params': {}}, 'head': v}, 'hourglass_ae')
    port.load_state_dict({k[len('keypoint_head.'):]: t
                          for k, t in sd.items()}, strict=True)
    xs = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    for mode, want in ((False, evals), (True, trains)):
        port.train(mode)
        with torch.no_grad():
            got = port(xs)
        assert len(got) == 2
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    back = _vars(*_convert_ae_multi_head(
        {k: t.numpy() for k, t in sd.items()}))
    want = dict(jax.tree_util.tree_leaves_with_path(v))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)


def _multi_scale_case(infer_refs, name):
    model, est, v, _, _, _ = infer_refs[name]
    model = copy.deepcopy(model)
    MODELS_OF[id(model)] = name
    img = np.random.RandomState(13).randint(0, 256, (50, 70, 3)).astype(
        np.uint8)
    kw = dict(test_scale_factor=(1.0,), base_size=64)
    hm, _, _, _ = multi_scale_maps(model, img, **kw)
    v = shift_biases(model, v, hm)
    return model, est, v, img, kw


def test_multi_scale_api_keeps_the_last_stage_as_jax(infer_refs):
    """Scale 1 with the flip: the maps the parser gets are the last stack's
    alone (JAX's select_output_index, the reference config's [3]), not
    every stack's average; grouped on the host into JAX's poses and scores.
    The grouping is held on JAX's maps: the random weights' tags leave
    near-ties that the maps' 1e-6 differences decide."""
    model, est, v, img, kw = _multi_scale_case(infer_refs, 'hourglass_ae')
    est = copy.copy(est)
    est.apply = _compiled_apply(est)
    hm, tags, center, scale = multi_scale_maps(model, img, **kw)
    want, jmaps = recording_parse(
        est.parser, lambda: jax_multi_scale(est, v, img, pose_nms_thr=None,
                                            **kw)[0])
    for a, b in zip((hm, tags), jmaps):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    got = inference.group_bottom_up(
        model, *(torch.from_numpy(np.array(m)) for m in jmaps), center,
        scale, pose_nms_thr=None)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a['keypoints'], np.asarray(
            b['keypoints']), atol=POSE_TOL_PX, rtol=0)
        np.testing.assert_allclose(a['score'], b['score'], rtol=1e-4,
                                   atol=1e-6)
    maps = jmaps
    # every stack aggregated (what the port did before) is another answer
    split = inference.split_ae_outputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(inference, 'split_ae_outputs',
                   lambda outs, *a: split(outs, *a[:3],
                                          list(range(len(outs)))))
        every, _, _, _ = multi_scale_maps(model, img, **kw)
    assert np.abs(every.numpy() - maps[0]).max() > 1e-2


def test_init_pose_model_reads_the_jax_npz(infer_refs, tmp_path):
    """init_pose_model on the cut Hourglass-AE config and an .npz of JAX's
    variables (the parameterless head has none) gives the same model."""
    model, _, v, x, _, _ = infer_refs['hourglass_ae']
    npz = str(tmp_path / 'hourglass_ae.npz')
    save_params_npz(npz, v)
    est = init_pose_model(mdict('hourglass_ae'), npz, device='cpu')
    assert isinstance(est, BottomUpEstimator) and est.multi_stage
    xt = torch.from_numpy(x)
    for a, b in zip(est.infer(xt, FLIP), model.infer(xt, FLIP)):
        assert torch.equal(a, b)


# --- training ----------------------------------------------------------------

def f64_dict(name):
    """`name`'s model dict with the backbone in float64."""
    m = mdict(name)
    m['backbone_overrides'] = dict(m['backbone_overrides'], dtype='float64')
    return m


@pytest.fixture(scope='module')
def train_runs(infer_refs):
    """Two steps of Hourglass-AE (the parameterless head: the optimizer
    holds the backbone alone) in the port and in JAX, from the same weights,
    on a one-scale batch at 64 -> 16, the backbone in float64 on both sides
    (each training-mode BN of its 4x4 maps takes 32 values a channel, and
    f32 loses digits there in both packages; the head's maps and the loss
    stay f32 in both): (port metrics, port final state
    dict, JAX metrics, JAX final variables as a port state dict, initial
    state dict, port and JAX first moments)."""
    name = 'hourglass_ae'
    batch = train_batch(40)
    batch.update(multi_heatmaps=batch['multi_heatmaps'][:1],
                 multi_masks=batch['multi_masks'][:1])
    model = build_model_from_cfg(f64_dict(name)).double()
    model.load_state_dict(port_model(name, infer_refs[name][2]).state_dict())
    init = {k: t.clone() for k, t in model.state_dict().items()}
    est = jax_build(f64_dict(name))
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: np.asarray(a, np.float64),
                         infer_refs[name][2])
        _, step = jloop.make_bottomup_train_step(est)
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
        params, stats = jloop.split_bottomup_variables(v)
        assert params['head'] == {}
        opt = tx.init(params)
        jbatch = jax.tree.map(jnp.asarray, batch)
        fast = jax.jit(functools.partial(step, tx=tx)).lower(
            params, stats, opt, jbatch).compile(
                compiler_options={'xla_backend_optimization_level': 1})
        jm = []
        for i in range(2):
            params, stats, opt, m = fast(params, stats, opt, jbatch)
            jm.append({k: float(x) for k, x in m.items()})
            if i == 0:
                mu = bottomup_state_dict_from_flax(
                    {part: {'params': jax.tree.map(np.asarray, tree)}
                     for part, tree in _adam_mu(opt).items()},
                    'hourglass_ae')
        jsd = bottomup_state_dict_from_flax(jax.tree.map(
            np.asarray, jloop.join_bottomup_variables(params, stats)),
            'hourglass_ae')
    state = ploop.bottomup_train_state(model, LR, [])
    pstep = ploop.make_bottomup_train_step(model)
    pm = []
    for i in range(2):
        pm.append({k: float(x) for k, x in pstep(
            state, ploop.batch_to_device(batch, 'cpu')).items()})
        if i == 0:
            pmu = {n: state.optimizer.state[p]['exp_avg'].clone()
                   for n, p in model.named_parameters()}
    return pm, state.model.state_dict(), jm, jsd, init, pmu, mu


def test_two_train_steps_over_every_stack_match_jax(train_runs):
    """The heatmap loss of every stack against the one-scale target, the
    tag loss of the first, the clipped gradients as Adam's first moment,
    and every parameter and BN statistic after two steps."""
    pm, sd, jm, jsd, init, pmu, mu = train_runs
    for step, (a, b) in enumerate(zip(pm, jm)):
        for key in ('heatmap_loss', 'push_loss', 'pull_loss', 'total_loss'):
            np.testing.assert_allclose(a[key], b[key], rtol=METRIC_RTOL,
                                       err_msg=f'step {step} {key}')
    assert pm[0]['push_loss'] > 0 and pm[0]['pull_loss'] > 0
    top = max(np.abs(m.numpy()).max() for m in mu.values())
    assert sorted(pmu) == sorted(mu)
    for key, got in pmu.items():
        want = mu[key].numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max()
                                   + 1e-6 * top, err_msg=f'grad {key}')
    flipped = total = 0
    for key, value in sd.items():
        if 'num_batches' in key:
            continue
        got, want = value.numpy(), jsd[key].numpy()
        if 'running' in key:
            np.testing.assert_allclose(got, want, **BN_TOL, err_msg=key)
            assert not np.array_equal(got, init[key].numpy()), key
            continue
        bad = np.abs(got - want) > PARAM_TOL['atol'] \
            + PARAM_TOL['rtol'] * np.abs(want)
        flipped += int(bad.sum())
        total += got.size
        assert np.abs(got - want).max() <= 4 * LR, key
    assert flipped <= FLIPPED_SHARE * total
