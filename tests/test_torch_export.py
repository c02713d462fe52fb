"""The port's export CLI (`vitpose_tpu_torch.tools.export`, counterpart of
tools/deployment/export.py) on the CPU: torch.export of the serving
function with K1 as `vitpose.attention_fwd` in the graph, saved as .pt2,
reloaded through `load_exported` and held to the eager port and to JAX.

Tolerances: the reloaded program equals the eager port bit for bit (the
same ops on the CPU) and JAX's `infer` heatmaps, flip test on, within
1e-5 relative and absolute, the tolerance of tests/test_export.py. The JAX
side runs the same weights with fused_attention=False, the same math in
XLA at optimisation level 0, so that no Pallas interpret run is needed.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data import DatasetInfo as JaxDatasetInfo
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import infer as jax_infer
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.utils.checkpoint import save_params_npz

from test_torch_models import (SMALL, _compile_fast, _peaked,
                               _random_variables, _small)
from vitpose_tpu_torch.api import init_pose_model
from vitpose_tpu_torch.models import infer
from vitpose_tpu_torch.tools import export
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COCO = os.path.join(ROOT, 'vitpose_tpu', 'configs', 'coco')
BATCH = 2


def _config(tmp_path):
    """The small model (tests/test_torch_models.py) as a config file, with
    K1 turned on: on the CPU the op runs its plain kernel."""
    path = tmp_path / 'small.py'
    path.write_text(
        "_base_ = ['" + COCO + "/../base/coco_data.py']\n"
        "model = dict(variant='b', img_size=(64, 48), out_channels=17,\n"
        "             deconv_filters=(16, 16), flip_test=True,\n"
        "             backbone_overrides=dict(fused_attention=True, "
        + ', '.join(f'{k}={v}' for k, v in SMALL.items()) + '))\n')
    return str(path)


def _crops():
    return np.random.RandomState(31).rand(BATCH, 64, 48, 3) \
        .astype(np.float32)


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """(the CLI's reloaded program and parity error, the .pt2 path, the
    eager port model, JAX's flip-tested heatmaps of _crops() on the same
    weights)."""
    tmp = tmp_path_factory.mktemp('export')
    variables = _peaked(_random_variables(seed=30, out_channels=17))
    npz = str(tmp / 'small.npz')
    save_params_npz(npz, variables)
    out = str(tmp / 'small.pt2')
    cfg = _config(tmp)
    reloaded, err = export.main([cfg, '--checkpoint', npz, '--out', out,
                                 '--batch', str(BATCH), '--device', 'cpu'])
    eager = init_pose_model(cfg, checkpoint=npz, device='cpu')
    model = JaxTopDown(_small(jax_make_config, out_channels=17))
    fi = JaxDatasetInfo.load('coco').flip_index
    ref = _compile_fast(lambda x: jax_infer(model, variables, x,
                                            flip_index=fi),
                        jnp.asarray(_crops()))
    return reloaded, err, out, eager, np.asarray(ref)


def test_export_round_trip_matches_eager_and_jax(exported):
    """The graph holds K1 as the custom op, once per block and pass of the
    flip test; the file reloads in a fresh load_exported and equals the
    eager port bit for bit and JAX within 1e-5."""
    reloaded, err, path, pm, ref = exported
    assert err == 0.0
    code = reloaded.graph_module.code
    assert code.count('vitpose.attention_fwd') == SMALL['depth'] * 2
    program = export.load_exported(path).module()
    x = torch.from_numpy(_crops())
    with torch.no_grad():
        got = program(x)
        eager = infer(pm.model, x, flip_index=pm.flip_index_tensor())
    assert torch.equal(got, eager)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('case', ['savedmodel', 'cnn'])
def test_export_refuses_what_is_not_ported(case, tmp_path):
    """--format savedmodel needs TensorFlow and is refused. A CNN config
    was refused too until the CNN port (the name stays): a tiny HRNet
    override of the zoo's HRNet-W32 config now exports, the program holds
    no attention op, and the reload equals eager."""
    out = str(tmp_path / 'm.pt2')
    if case == 'savedmodel':
        with pytest.raises(NotImplementedError, match='TensorFlow'):
            export.main([_config(tmp_path), '--out', out, '--device', 'cpu',
                         '--format', 'savedmodel'])
        assert not os.path.exists(out)
        return
    cfg = tmp_path / 'hrnet_small.py'
    cfg.write_text(
        f"_base_ = ['{os.path.join(COCO, 'hrnet_w32_coco_256x192.py')}']\n"
        "model = dict(img_size=(64, 48), dtype='float32',\n"
        "             backbone_overrides=dict(width=8, stage_modules=(1, 1),"
        "\n                                     stage_blocks=1,\n"
        "                                     dtype='float32'))\n")
    reloaded, err = export.main([str(cfg), '--out', out, '--batch', '2',
                                 '--device', 'cpu'])
    assert err == 0.0
    assert 'vitpose.attention_fwd' not in reloaded.graph_module.code
    pm = init_pose_model(str(cfg), device='cpu')
    assert pm.model.backbone_type == 'hrnet'
    x = torch.from_numpy(_crops())
    program = export.load_exported(out).module()
    with torch.no_grad():
        got = program(x)
        eager = infer(pm.model, x, flip_index=pm.flip_index_tensor())
    assert got.shape == (len(x), 17, 16, 12)
    assert torch.equal(got, eager)


@pytest.mark.slow
def test_export_cli(tmp_path):
    """The export CLI end to end on a zoo config, as a user runs it (the
    counterpart of tests/test_export.py::test_export_cli)."""
    import subprocess
    import sys
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run(
        [sys.executable, '-m', 'vitpose_tpu_torch.tools.export',
         os.path.join(COCO, 'vitpose_s_coco_256x192.py'),
         '--out', str(tmp_path / 'm.pt2'), '--batch', '1', '--device',
         'cpu'], capture_output=True, text=True, timeout=900, env=env,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert 'reload parity max err' in out.stdout
    assert (tmp_path / 'm.pt2').exists()
