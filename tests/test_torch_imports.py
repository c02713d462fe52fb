"""Layout and isolation rules of the PyTorch port.

The import ban is an AST scan, not a look at sys.modules: the test process
has JAX loaded already (tests/conftest.py).
"""
import ast
import importlib
from pathlib import Path

import pytest
import torch
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / 'vitpose_tpu_torch'
BANNED = ('jax', 'flax', 'vitpose_tpu')

MODULES = ['ops.attention', 'kernels._build', 'models.vit', 'models.heads',
           'models.topdown', 'models.losses', 'utils.convert',
           'ops.geometry', 'ops.warp', 'ops.decode', 'ops.target',
           'data.dataset_info', 'data.pipeline', 'api.inference',
           'train.optim', 'train.state', 'train.step', 'utils.config',
           'data.coco_index', 'ops.nms', 'eval', 'eval.cocoeval',
           'data.topdown', 'data.native', 'data.loader', 'data',
           'train.loop', 'utils.torch_ckpt', 'eval.loop', 'tools.test',
           'utils.checkpoint', 'utils.env', 'parallel',
           'parallel.distributed', 'tools.train', 'data.mpii',
           'data.wholebody', 'tools.model_split', 'utils.quantize',
           'api.tracking', 'ops.smoothing', 'tools.serve', 'api',
           'tools.export', 'utils.timer', 'utils.video', 'api.webcam',
           'webcam', 'webcam.buffer', 'webcam.event', 'webcam.message',
           'webcam.misc', 'webcam.node', 'webcam.pose_utils',
           'webcam.runner', 'webcam.model_nodes', 'webcam.helper_nodes',
           'webcam.effect_nodes', 'tools.run_webcam', 'demo', 'demo._video',
           'demo.top_down_img_demo', 'demo.top_down_img_demo_with_det',
           'demo.top_down_video_demo', 'demo.top_down_video_demo_with_det',
           'demo.top_down_pose_tracking_demo', 'demo.face_img_demo',
           'demo.face_video_demo', 'demo.webcam_demo', 'tools.test_new',
           'tools.eval_detector', 'tools.train_comet', 'tools.misc',
           'tools.misc.keypoints2coco_without_mmdet',
           'tools.misc.publish_model', 'tools.analysis',
           'tools.analysis._common', 'tools.analysis.get_flops',
           'tools.analysis.speed_test', 'tools.analysis.benchmark_inference',
           'tools.analysis.benchmark_processing',
           'tools.analysis.profile_trace', 'tools.analysis.overfit_sanity',
           'tools.analysis.print_config',
           'tools.analysis.int8_selective_sweep',
           'tools.analysis.bench_attn_pack',
           'tools.analysis.bench_batch_sweep',
           'tools.analysis.bench_breakdown',
           'tools.analysis.bench_fused_attention', 'tools.analysis.bench_io',
           'tools.analysis.bench_train', 'tools.analysis.bench_zoo',
           'tools.dataset',
           'tools.dataset._coco', 'tools.dataset.parse_animalpose_dataset',
           'tools.dataset.parse_cofw_dataset',
           'tools.dataset.parse_deepposekit_dataset',
           'tools.dataset.parse_macaquepose_dataset',
           'tools.dataset.h36m_to_coco']


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    'path', sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py'],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_flax_or_jax_package_import(path):
    for name in _imported_names(path):
        top = name.split('.')[0]
        assert top not in BANNED, f'{path.name} imports {name}'


@pytest.mark.parametrize('name', MODULES)
def test_port_module_imports_without_cuda(name):
    importlib.import_module(f'vitpose_tpu_torch.{name}')


def test_kernel_source_and_metadata_are_in_the_package():
    assert (PORT / 'csrc' / 'attention_fwd.cu').is_file()
    assert (PORT / 'csrc' / 'attention_bwd.cu').is_file()
    assert (PORT / 'csrc' / 'loader.cpp').is_file()
    assert (PORT / 'data' / 'metadata' / 'coco.json').is_file()
    assert len(list((PORT / 'data' / 'metadata').glob('*.json'))) == 37


def test_native_loader_is_the_ports_own():
    """The port builds its own loader library and never names the JAX
    package's binary."""
    from vitpose_tpu_torch.kernels import _build
    for path in sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']:
        assert 'libvtp_loader' not in path.read_text(), path
    if _build.has_header('jpeglib.h'):
        lib = _build.build_host('loader')
        assert lib.parent == PORT / 'kernels' / 'build' and lib.is_file()


def test_cuda_entry_point_raises_without_cuda(monkeypatch):
    from vitpose_tpu_torch.api import init_pose_model
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        init_pose_model('s', device='cuda')
