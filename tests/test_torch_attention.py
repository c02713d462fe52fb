"""The port's attention against the JAX package on the CPU, the dispatch rule
of its wrapper, and (on a CUDA card only) the K1 kernel against its plain
version.

Tolerances: f32 1e-5. bf16 4e-3 absolute plus 1e-2 relative: the output is
rounded to bf16 on both sides (one step is at most 2^-7 of |o|, inside the
relative part), and the probabilities are rounded to bf16 before the PV
product, at a different point of the softmax in the TPU kernel (normalised P)
than in a flash-style kernel (a few 1e-3 where |o| is small).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.ops.attention import fused_attention as jax_fused
from vitpose_tpu.ops.attention import reference_attention as jax_reference

from vitpose_tpu_torch.ops import attention as tattn

TOLS = {'float32': dict(rtol=1e-5, atol=1e-5),
        'bfloat16': dict(rtol=1e-2, atol=4e-3)}


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _to_f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


CASES = [(shape, dtype) for shape in [(1, 48, 4, 32), (1, 40, 2, 80)]
         for dtype in ('float32', 'bfloat16')]


@pytest.fixture(scope='module')
def jax_outputs():
    """(inputs, Pallas interpret output, reference output) per case, from
    one JAX program."""
    inputs = [[jnp.asarray(a).astype(dtype) for a in _qkv(shape, sum(shape))]
              for shape, dtype in CASES]
    def fn(inputs):
        return [(jax_fused(*qkv, interpret=True), jax_reference(*qkv))
                for qkv in inputs]

    # XLA's CPU backend at optimisation level 0 compiles this in half the
    # time and gives bit-identical outputs here
    compiled = jax.jit(fn).lower(inputs).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    return inputs, compiled(inputs)


@pytest.mark.parametrize('case', range(len(CASES)),
                         ids=[f'{s}-{d}' for s, d in CASES])
def test_plain_attention_matches_jax(jax_outputs, case):
    shape, dtype = CASES[case]
    inputs, outputs = jax_outputs
    tq, tk, tv = (torch.from_numpy(_to_f32(a)).to(getattr(torch, dtype))
                  for a in inputs[case])
    before = tattn.fused_attention.launches
    out = tattn.attention(tq, tk, tv)
    assert tattn.fused_attention.launches == before    # CPU: no kernel
    assert out.dtype == tq.dtype and out.shape == shape
    for ref in outputs[case]:
        np.testing.assert_allclose(out.float().numpy(), _to_f32(ref),
                                   **TOLS[dtype])


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 2, 32)
    before = tattn.fused_attention.launches
    with pytest.raises(ValueError, match='CUDA'):
        tattn.fused_attention(q, q, q)
    assert tattn.fused_attention.launches == before


@pytest.mark.parametrize('case', ['float16', 'head_dim_8', 'bf16_unaligned',
                                  'shape_mismatch'])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Checked before the device, so each refusal shows on the CPU too."""
    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    k = v = q
    if case == 'float16':
        q = k = v = q.half()
    elif case == 'head_dim_8':
        q = k = v = q[..., :8].contiguous()
    elif case == 'bf16_unaligned':               # token stride 36 elements
        q = torch.zeros(1, 8, 2, 36, dtype=torch.bfloat16)[..., :32]
    else:
        k = torch.zeros(1, 9, 2, 32, dtype=torch.bfloat16)
    match = {'float16': 'dtype', 'head_dim_8': 'head dim 8',
             'bf16_unaligned': 'aligned', 'shape_mismatch': 'shape'}[case]
    before = tattn.fused_attention.launches
    with pytest.raises(ValueError, match=match):
        tattn.fused_attention(q, k, v)
    assert tattn.fused_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('shape,dtype', [
    ((2, 192, 12, 64), torch.bfloat16), ((2, 192, 12, 64), torch.float32),
    ((3, 48, 5, 32), torch.float32), ((1, 972, 2, 80), torch.bfloat16),
    ((4, 72, 12, 64), torch.bfloat16)])
def test_kernel_matches_plain_on_card(shape, dtype):
    """K1 on strided q/k/v views of one qkv tensor, as the ViT feeds it.
    T=72 leaves 8 real keys in the last 64-key tile, so a wrong key mask
    moves the output far past the bf16 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: K1 has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False    # a true f32 reference
    n, t, h, d = shape
    g = torch.Generator(device='cuda').manual_seed(0)
    qkv = torch.randn(n, t, 3, h, d, generator=g, device='cuda').to(dtype)
    q, k, v = qkv.unbind(2)
    before = tattn.fused_attention.launches
    out = tattn.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.fused_attention.launches == before + 1
    ref = tattn.reference_attention(q, k, v)
    tol = TOLS['float32' if dtype == torch.float32 else 'bfloat16']
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)
