"""Layout and isolation rules of the PyTorch port.

The import ban is an AST scan, not a look at sys.modules: the test process
has JAX loaded already (tests/conftest.py).
"""
import ast
import importlib
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / 'vitpose_tpu_torch'
BANNED = ('jax', 'flax', 'vitpose_tpu')

MODULES = ['ops.attention', 'kernels._build', 'models.vit', 'models.heads',
           'models.topdown', 'models.losses', 'utils.convert',
           'ops.geometry', 'ops.warp', 'ops.decode', 'ops.target',
           'data.dataset_info', 'data.pipeline', 'api.inference',
           'train.optim', 'train.state', 'train.step']


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
    assert (PORT / 'data' / 'metadata' / 'coco.json').is_file()


def test_cuda_entry_point_raises_without_cuda(monkeypatch):
    from vitpose_tpu_torch.api import init_pose_model
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        init_pose_model('s', device='cuda')
