"""The port's analysis and dataset tools of ROADMAP item 14, on the CPU at a
small size (ViT width 32, depth 2): `get_flops` held exactly to the analytic
count of the products, `print_config` to JAX's text, the dataset tools'
jsons to JAX's byte for byte, the int8 sweep's harness to JAX's, and the
plumbing of `speed_test`, `benchmark_inference`, `benchmark_processing`,
`profile_trace` and `overfit_sanity` with `--device cpu`.

The dataset tools' synthetic inputs are copies of those of
tests/test_dataset_tools.py. The port's tools are called in process
(`main(argv)`); the JAX tools are loaded from tools/ by file path.
"""
import csv
import dataclasses
import importlib.util
import json
import os
import pickle
import sys
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data import TopDownDataset as JaxTopDownDataset
from vitpose_tpu.data.loader import TopDownLoader as JaxTopDownLoader
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config

from test_torch_data import COCO_B, write_coco_fixture
from test_torch_eval import _small_config
from test_torch_models import SMALL, _fill, _small
from vitpose_tpu_torch.data import TopDownDataset
from vitpose_tpu_torch.data.loader import TopDownLoader
from vitpose_tpu_torch.models import TopDownModel
from vitpose_tpu_torch.tools.analysis import (benchmark_inference,
                                              benchmark_processing,
                                              get_flops,
                                              int8_selective_sweep,
                                              overfit_sanity, print_config,
                                              profile_trace, speed_test)
from vitpose_tpu_torch.tools.dataset import (h36m_to_coco,
                                             parse_animalpose_dataset,
                                             parse_cofw_dataset,
                                             parse_deepposekit_dataset,
                                             parse_macaquepose_dataset)
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(rel):
    """A JAX package tool module, loaded from tools/ by file path."""
    path = os.path.join(ROOT, 'tools', rel)
    spec = importlib.util.spec_from_file_location(
        'jax_tool_' + rel.replace('/', '_')[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    """The small ViT config file and a COCO set with 8 GT persons."""
    root = tmp_path_factory.mktemp('analysis')
    return dict(config=_small_config(root),
                coco=write_coco_fixture(str(root / 'coco'), seed=0),
                root=root)


# --- get_flops ---------------------------------------------------------------

def analytic_flops(depth, dim, heads, grid, filters, joints, mlp_ratio=4):
    """2 FLOPs per multiply-add of the small ViTPose at batch 1: the 16x16
    patch conv, each block's qkv, proj, fc1 and fc2 and its QK^T and PV,
    the two 4x4 stride-2 deconvs (Cin * Cout * 16 per input pixel) and the
    1x1 final conv."""
    hp, wp = grid
    t = hp * wp
    patch = 2 * dim * 3 * 16 * 16 * t
    block = (2 * t * dim * (3 * dim + dim + 2 * mlp_ratio * dim)
             + 4 * heads * t * t * (dim // heads))
    deconv, cin, pixels = 0, dim, t
    for c in filters:
        deconv += 2 * cin * c * 16 * pixels
        cin, pixels = c, pixels * 4
    return patch + depth * block + deconv + 2 * cin * joints * pixels


@pytest.mark.parametrize('fused', [False, True])
def test_get_flops_equals_the_analytic_count(small, fused, capsys):
    """Exactly the analytic count, on the plain attention path (its einsums)
    and through the custom op's registered formula; JAX's XLA figure of the
    same model is printed beside it, with the gap (XLA also counts the
    elementwise work)."""
    opts = [f'model.backbone_overrides.fused_attention={fused}']
    got = get_flops.main([small['config'], '--device', 'cpu',
                          '--cfg-options', *opts])
    want = analytic_flops(SMALL['depth'], SMALL['embed_dim'],
                          SMALL['num_heads'], (4, 3), (16, 16), 17)
    assert got['flops'] == want
    assert got['shape'] == (1, 64, 48, 3)
    assert ('vitpose.attention_fwd' in got['per_op']) == fused
    assert 'FLOPs' in capsys.readouterr().out
    if fused:
        return
    jm = JaxTopDown(_small(jax_make_config, out_channels=17))
    x = jax.ShapeDtypeStruct((1, 64, 48, 3), jnp.float32)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    xla = jax.jit(lambda v, x: jm.apply(v, x, train=False)).lower(
        v, x).compile().cost_analysis()['flops']
    with capsys.disabled():
        print(f'\nget_flops, small ViT: port {got["flops"]}, JAX (XLA cost '
              f'analysis) {xla:.0f}, gap {xla - got["flops"]:.0f} '
              f'({xla / got["flops"] - 1:+.1%})')


# --- print_config ------------------------------------------------------------

def test_print_config_text_equals_jax(capsys, monkeypatch):
    args = [COCO_B, '--cfg-options', 'data.batch_size=8',
            'model.backbone_overrides.drop_path_rate=0.2']
    print_config.main(args)
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['print_config.py', *args])
    _jax_tool('analysis/print_config.py').main()
    assert port == capsys.readouterr().out
    assert "'batch_size': 8" in port


# --- dataset tools: the inputs of tests/test_dataset_tools.py ----------------

def _write_img(path, h=32, w=48):
    import cv2
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = (np.random.RandomState(0).rand(h, w, 3) * 255).astype(np.uint8)
    cv2.imwrite(path, img)
    return img


def _cofw_inputs(root):
    import h5py
    K, N = 29, 2
    xs = np.linspace(5, 20, K)
    phis = np.concatenate([xs, xs + 1, np.zeros(K)])
    os.makedirs(root, exist_ok=True)
    with h5py.File(os.path.join(root, 'COFW_train_color.mat'), 'w') as f:
        img = (np.random.RandomState(0).rand(3, 40, 30) * 255).astype(
            np.uint8)
        refs = []
        for i in range(N):
            refs.append(f.create_dataset(f'img{i}', data=img).ref)
        f['IsTr'] = np.array([refs], dtype=h5py.ref_dtype)
        f['phisTr'] = np.stack([phis] * N, axis=1)
        f['bboxesTr'] = np.stack([[2, 3, 25, 25]] * N, axis=1)


def _macaque_inputs(root):
    _write_img(os.path.join(root, 'images', 'm1.jpg'))
    kps = [[{'position': [3.0, 4.0]}] + [{'position': None}] * 16]
    segs = [[{'segment': [[0, 0], [10, 0], [10, 8], [0, 8]]}]]
    with open(os.path.join(root, 'annotations.csv'), 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['image', 'keypoints', 'segmentation'])
        writer.writerow(['m1.jpg', json.dumps(kps), json.dumps(segs)])


def _deepposekit_inputs(root):
    import h5py
    ddir = os.path.join(root, 'datasets', 'zebra')
    os.makedirs(ddir)
    N, K = 10, 9
    rng = np.random.RandomState(0)
    with h5py.File(os.path.join(ddir, 'annotation_data_release.h5'),
                   'w') as f:
        f['annotations'] = rng.rand(N, K, 2) * 20 + 1
        f['annotated'] = np.ones((N, K), bool)
        f['images'] = (rng.rand(N, 24, 24, 1) * 255).astype(np.uint8)
        parents = np.array([-1, 0, 1, 2, 2, 2, 2, 2, 7])
        f['skeleton'] = np.stack([parents, np.arange(K)], axis=1)


def _animalpose_inputs(root, stem='2008_000123'):
    el = ET.Element('annotation')
    ET.SubElement(el, 'image').text = stem
    ET.SubElement(el, 'category').text = 'dog'
    vb = ET.SubElement(el, 'visible_bounds')
    for k, v in (('xmin', '10.0'), ('ymin', '5.0'), ('width', '50.0'),
                 ('height', '40.0')):
        vb.set(k, v)
    kpts = ET.SubElement(el, 'keypoints')
    for i, name in enumerate(parse_animalpose_dataset.NAME2ID):
        kp = ET.SubElement(kpts, 'keypoint')
        kp.set('name', name)
        kp.set('visible', '1' if i < 10 else '0')
        kp.set('x', str(10.0 + i))
        kp.set('y', str(20.0 + i))
    xml_dir = os.path.join(root, 'xmls', 'dog')
    os.makedirs(xml_dir, exist_ok=True)
    ET.ElementTree(el).write(os.path.join(xml_dir, f'{stem}_1.xml'))


def _h36m_inputs(root):
    N, K = 2, 17
    rng = np.random.RandomState(0)
    names = [f'S1_Directions_1.54138969_{i:06d}.jpg' for i in range(N)]
    for n in names:
        _write_img(os.path.join(root, 'imgs', n), 64, 64)
    np.savez(os.path.join(root, 'ann.npz'),
             imgname=np.array(names),
             center=np.array([[50.0, 50.0]] * N),
             scale=np.array([1.5] * N),
             part=rng.rand(N, K, 3),
             S=np.concatenate([rng.rand(N, K, 3), np.ones((N, K, 1))], -1))
    cams = {('S1', '54138969'): {'R': np.eye(3),
                                 'T': np.array([[1.], [2.], [3.]]),
                                 'f': [1000., 1000.], 'c': [500., 500.]}}
    with open(os.path.join(root, 'cams.pkl'), 'wb') as f:
        pickle.dump(cams, f)


def _files(root, rel_paths):
    out = {}
    for rel in rel_paths:
        with open(os.path.join(root, rel), 'rb') as f:
            out[rel] = f.read()
    return out


DATASET_TOOLS = {
    'cofw': (_cofw_inputs, parse_cofw_dataset, 'parse_cofw_dataset',
             lambda mod, root: mod.convert(root),
             ['annotations/cofw_train.json', 'images/000001.jpg']),
    'macaque': (_macaque_inputs, parse_macaquepose_dataset,
                'parse_macaquepose_dataset',
                lambda mod, root: mod.convert(root, train_num=1),
                ['annotations/macaque_train.json',
                 'annotations/macaque_test.json']),
    'deepposekit': (_deepposekit_inputs, parse_deepposekit_dataset,
                    'parse_deepposekit_dataset',
                    lambda mod, root: mod.convert(root, 'zebra'),
                    ['datasets/zebra/annotations/zebra_train.json',
                     'datasets/zebra/annotations/zebra_test.json',
                     'datasets/zebra/images/3.jpg']),
    'animalpose': (_animalpose_inputs, parse_animalpose_dataset,
                   'parse_animalpose_dataset',
                   lambda mod, root: mod.save_json(
                       mod.convert(os.path.join(root, 'xmls'), root,
                                   image_size=(375, 500)),
                       os.path.join(root, 'out.json')),
                   ['out.json']),
    'h36m': (_h36m_inputs, h36m_to_coco, 'h36m_to_coco',
             lambda mod, root: mod.save_json(
                 mod.convert(os.path.join(root, 'ann.npz'),
                             os.path.join(root, 'cams.pkl'),
                             os.path.join(root, 'imgs')),
                 os.path.join(root, 'out.json')),
             ['out.json']),
}


@pytest.mark.parametrize('name', sorted(DATASET_TOOLS))
def test_dataset_tool_writes_jax_bytes(name, tmp_path, monkeypatch):
    """Each converter on the same synthetic release writes the same files
    as JAX's, byte for byte (the jsons' float formatting and key order,
    and the images it writes)."""
    make, port_mod, jax_name, run, outputs = DATASET_TOOLS[name]
    monkeypatch.syspath_prepend(os.path.join(ROOT, 'tools', 'dataset'))
    jax_mod = _jax_tool(f'dataset/{jax_name}.py')
    written = []
    for side, mod in (('port', port_mod), ('jax', jax_mod)):
        root = str(tmp_path / side)
        make(root)
        run(mod, root)
        written.append(_files(root, outputs))
    assert written[0] == written[1]
    data = json.loads(written[0][outputs[0]])
    assert data['annotations'] and data['categories'][0]['keypoints']


# --- the int8 sweep's harness and run ----------------------------------------

def test_int8_sweep_harness_matches_jax(small):
    """fixture_crops against JAX's `_fixture_crops` (crops within 5e-4,
    crop joints within 1e-4, visibility equal) and fit_final_conv against JAX's
    `_fit_final_conv` on the same small ViT at 256x192 (width 32, depth
    2): the fitted weights within 2e-3 of their largest (JAX builds X^T X
    in f32, the port in f64) and the exact model's heatmaps within 1e-3
    of their largest."""
    from test_int8_realscale_neutrality import (_fit_final_conv,
                                                _fixture_crops)
    from vitpose_tpu_torch.utils.convert import state_dict_from_flax
    coco = small['coco']
    kw = dict(dataset_info='coco', image_size=(192, 256),
              heatmap_size=(48, 64), test_mode=True, use_gt_bbox=True)
    jloader = JaxTopDownLoader(JaxTopDownDataset(coco['ann'], coco['prefix'],
                                                 **kw), 7, is_train=False)
    ploader = TopDownLoader(TopDownDataset(coco['ann'], coco['prefix'], **kw),
                            7, is_train=False)
    jcrops, jjoints, jvis = _fixture_crops(jloader)
    crops, joints, vis = int8_selective_sweep.fixture_crops(ploader, 'cpu')
    # bilinear taps from f32 source coordinates up to 640 px (4e-5 px),
    # times a slope of up to 1/0.225 per pixel after normalisation
    np.testing.assert_allclose(crops.numpy(), jcrops, rtol=0, atol=5e-4)
    np.testing.assert_allclose(joints.numpy(), jjoints, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(vis.numpy(), jvis)
    jcfg = jax_make_config('b', img_size=(256, 192), head='simple',
                           out_channels=17, flip_test=True, use_udp=True,
                           post_process='default', shift_heatmap=False)
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, **SMALL))
    jm = JaxTopDown(jcfg)
    jv = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 256, 192, 3))), 3)
    flip_index = np.asarray(ploader.ds.info.flip_index)
    jv = _fit_final_conv(jm, jv, jcrops, jjoints, jvis, flip_index)
    cfg = int8_selective_sweep.sweep_config(**SMALL)
    model = TopDownModel(cfg).eval()
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, jv)),
                          strict=True)
    ref_w = model.keypoint_head.final_layer.weight.detach().clone()
    int8_selective_sweep.fit_final_conv(model, crops, joints, vis,
                                        flip_index)
    w = model.keypoint_head.final_layer.weight.detach()
    assert (w - ref_w).abs().max() <= 2e-3 * ref_w.abs().max()
    with torch.no_grad():
        hm = model(crops[:2])
    ref = np.asarray(jm.apply(jv, jnp.asarray(jcrops[:2]), train=False))
    assert np.abs(hm.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()


def test_int8_sweep_runs(small, capsys):
    """Two grid points and the per-block mode on the small ViT: one row
    each, quantised block counts as asked, the summary line."""
    coco = small['coco']
    cfg = int8_selective_sweep.sweep_config(**SMALL)
    out = int8_selective_sweep.sweep(coco['ann'], coco['prefix'],
                                     grid=[(0, 0), (1, 0)], device='cpu',
                                     cfg=cfg)
    assert [r['quantized_blocks'] for r in out['rows']] == [2, 1]
    assert all(0 <= r['oks_min'] <= r['oks_mean'] <= 1 for r in out['rows'])
    assert 0 < out['exact']['AP'] <= 1
    per = int8_selective_sweep.sweep(coco['ann'], coco['prefix'],
                                     per_block=True, device='cpu', cfg=cfg)
    assert [r['quantized'] for r in per['rows']] == [[0], [1]]
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1])['card'] == 'the CPU'
    assert all(r['card'] == 'the CPU' for r in out['rows'] + per['rows'])


# --- the timing tools' plumbing on the CPU -----------------------------------

def test_speed_test_and_benchmark_inference(small, capsys):
    cfg = small['config']
    out = speed_test.main([cfg, '--bz', '2', '--iters', '2', '--warmup', '1',
                           '--device', 'cpu'])
    assert out['batch'] == 2 and len(out['times_ms']) == 2
    out = benchmark_inference.main([cfg, '--batch', '2', '--iters', '2',
                                    '--group', '2', '--device', 'cpu'])
    assert out['group'] == 2 and out['img_s'] > 0
    out = benchmark_inference.main([cfg, '--batch', '2', '--iters', '1',
                                    '--no-flip', '--int8-qkv', '--device',
                                    'cpu'])
    assert out['batch'] == 2
    out = benchmark_inference.main([cfg, '--latency', '--iters', '1',
                                    '--no-flip', '--device', 'cpu'])
    assert sorted(out['latency']) == [1, 8, 32]
    text = capsys.readouterr().out
    assert 'single forward' in text and 'flip test' in text
    assert all('on the CPU' in line for line in text.splitlines()
               if ' ms' in line or ' s ' in line)


def test_benchmark_processing(small):
    coco = small['coco']
    out = benchmark_processing.main(['--ann', coco['ann'], '--prefix',
                                     coco['prefix'], '--batch', '4',
                                     '--iters', '1', '--num-workers', '1',
                                     '--device', 'cpu'])
    assert out['host_images'] == 8 and out['device_batches'] == 2
    assert out['host_img_s'] > 0 and out['device_img_s'] > 0


@pytest.mark.parametrize('mode', ['infer', 'train'])
def test_profile_trace_writes_a_chrome_trace(small, tmp_path, mode):
    out = str(tmp_path / 'trace' / f'{mode}.json')
    res = profile_trace.main([small['config'], '--out', out, '--mode', mode,
                              '--batch', '2', '--steps', '1', '--device',
                              'cpu'])
    with open(out) as f:
        trace = json.load(f)
    names = {e.get('name') for e in trace['traceEvents']}
    assert 'aten::linear' in names or 'aten::addmm' in names
    assert res['kernels_us'] == {}              # no card, no kernels


def test_overfit_sanity_two_epochs(small, tmp_path, capsys):
    """JAX's recipe (128x96, width 128, depth 4) for 2 epochs on the 8
    persons: the evaluation at the last epoch is logged and printed."""
    coco = small['coco']
    cfg = overfit_sanity.overfit_config(coco['ann'], coco['prefix'], 2,
                                        str(tmp_path))
    assert cfg['model']['backbone_overrides']['fused_attention']
    evals = overfit_sanity.main(['--ann', coco['ann'], '--img-root',
                                 coco['prefix'], '--epochs', '2',
                                 '--work-dir', str(tmp_path / 'wd'),
                                 '--device', 'cpu'])
    assert [r['epoch'] for r in evals] == [1]
    assert 0 <= evals[0]['AP'] <= 1
    assert 'epoch 2: AP' in capsys.readouterr().out
