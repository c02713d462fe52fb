"""K1 and K2 as torch.library custom ops (`vitpose::attention_fwd`,
`vitpose::attention_bwd`) on the CPU: `opcheck` of both, K3 through the op
(`register_autograd`), the refusals of the fake kernels, and the remat
policy 'attn' on the plain einsum path against no remat and against JAX.

Tolerances: the op on the CPU runs `reference_attention(_bwd)`, so its
output and gradients equal them exactly; remat gradients equal those
without remat exactly (a recompute on the CPU repeats the same ops, as
tests/test_torch_train.py holds the other policies); against JAX's
gradient of the same small model under remat 'attn' (XLA optimisation
level 0), 1e-4 relative and absolute, the f32 model tolerance of
tests/test_torch_models.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config

from test_torch_models import (TOL, SMALL, _compile_fast, _port_model,
                               _random_variables, _small)
from vitpose_tpu_torch.models import make_config
from vitpose_tpu_torch.ops import attention as tattn
from vitpose_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

SHAPE = (2, 12, 4, 8)
SCALE = SHAPE[-1] ** -0.5


def _qkv(seed, shape=SHAPE):
    """Strided q, k, v views of one [N, T, 3, H, d] tensor, as the ViT
    gives them."""
    rng = np.random.RandomState(seed)
    n, t, h, d = shape
    qkv = torch.from_numpy(rng.randn(n, t, 3, h, d).astype(np.float32))
    return qkv.unbind(2)


@pytest.mark.parametrize('which', ['fwd', 'fwd_grad', 'bwd'])
def test_opcheck(which):
    """Schema, autograd registration, fake kernel against the real one and
    AOT dispatch with dynamic shapes (the backward through attention_bwd)."""
    q, k, v = _qkv(0)
    if which == 'bwd':
        g = torch.from_numpy(np.random.RandomState(1).randn(*SHAPE)
                             .astype(np.float32))
        op, args = torch.ops.vitpose.attention_bwd.default, (q, k, v, g, SCALE)
    else:
        if which == 'fwd_grad':
            q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
        op, args = torch.ops.vitpose.attention_fwd.default, (q, k, v, SCALE)
    torch.library.opcheck(op, args)


def test_k3_through_the_op_is_the_plain_path():
    """attention() calls the op; its output and q/k/v gradients equal the
    plain versions bit for bit, and no kernel wrapper counts a launch."""
    q, k, v = _qkv(2)
    g = torch.from_numpy(np.random.RandomState(3).randn(*SHAPE)
                         .astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (tattn.fused_attention.launches,
              tattn.fused_attention_bwd.launches)
    out = tattn.attention(*leaves)
    assert out.is_contiguous()
    out.backward(g)
    assert torch.equal(out.detach(), tattn.reference_attention(q, k, v))
    for leaf, ref in zip(leaves, tattn.reference_attention_bwd(q, k, v, g)):
        assert torch.equal(leaf.grad, ref)
    assert (tattn.fused_attention.launches,
            tattn.fused_attention_bwd.launches) == before


def test_fake_kernels_refuse_mismatched_and_unbuilt_inputs():
    """The checks that need no data run where fake tensors trace, for CUDA
    tensors with the kernels' dtypes and head dims."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q, k, _ = _qkv(4)
    with pytest.raises(ValueError, match='shape'):
        torch.ops.vitpose.attention_fwd(q, k[:, :5], k, SCALE)
    with FakeTensorMode():
        cuda = torch.empty(SHAPE, device='cuda')
        with pytest.raises(ValueError, match='head dim 8'):
            torch.ops.vitpose.attention_fwd(cuda, cuda, cuda, SCALE)
        out = torch.ops.vitpose.attention_bwd(
            *(torch.empty(1, 192, 12, 64, device='cuda',
                          dtype=torch.bfloat16),) * 4, 0.125)
        assert [tuple(x.shape) for x in out] == [(1, 192, 12, 64)] * 3
        assert all(x.is_contiguous() and x.device.type == 'cuda'
                   for x in out)


class _CountBmm(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += func is torch.ops.aten.bmm.default
        return func(*args, **(kwargs or {}))


def _plain_grads(policy):
    """Eval-mode gradients of mean(heatmaps^2) for the small f32 model on
    the plain path (fused_attention off), and the bmm calls it made."""
    kw = {} if policy == 'none' else dict(remat_blocks=True,
                                          remat_policy=policy)
    model = _port_model(_small(make_config, **kw),
                        _random_variables(seed=21))
    x = torch.from_numpy(_crops())
    with _CountBmm() as count:
        model(x).square().mean().backward()
    return {n: p.grad for n, p in model.named_parameters()}, count.calls


def _crops():
    return np.random.RandomState(22).randn(3, 64, 48, 3).astype(np.float32)


@pytest.fixture(scope='module')
def jax_remat_grads():
    """JAX's gradients of the same loss under remat 'attn' on its unfused
    path, as the port's state-dict names."""
    cfg = _small(jax_make_config, remat_blocks=True, remat_policy='attn')
    module = JaxTopDown(cfg)
    variables = _random_variables(seed=21)

    def loss(params):
        out = module.apply({'params': params,
                            'batch_stats': variables['batch_stats']},
                           jnp.asarray(_crops()), train=False)
        return jnp.mean(out ** 2)

    grads = _compile_fast(jax.grad(loss), variables['params'])
    return state_dict_from_flax({'params': grads,
                                 'batch_stats': variables['batch_stats']})


def test_remat_attn_on_the_plain_path(jax_remat_grads):
    """remat_policy='attn' with fused_attention=False keeps the PV product
    (JAX's 'attn_out'): the recompute runs only the QK^T product again, one
    bmm per block, and every gradient equals the one without remat; both
    agree with JAX's under the same policy."""
    ref, calls = _plain_grads('none')
    grads, remat_calls = _plain_grads('attn')
    assert remat_calls == calls + SMALL['depth']
    _, full_calls = _plain_grads('full')
    assert full_calls == calls + 2 * SMALL['depth']
    for name, g in grads.items():
        assert torch.equal(g, ref[name]), name
        np.testing.assert_allclose(g.numpy(), jax_remat_grads[name].numpy(),
                                   **TOL, err_msg=name)
