"""The port's attention against the JAX package on the CPU, the dispatch rule
of its wrappers, the choice of kernel design (`_plan`), the differentiable
K3, and (on a CUDA card only) the K1 and K2 kernels, in every design that
takes each shape, against their plain versions.

Tolerances of the forward: f32 1e-5. bf16 4e-3 absolute plus 1e-2 relative:
the output is rounded to bf16 on both sides (one step is at most 2^-7 of |o|,
inside the relative part), and the probabilities are rounded to bf16 before
the PV product, at a different point of the softmax in the TPU kernel
(normalised P) than in a flash-style kernel (a few 1e-3 where |o| is small).

Tolerances of the backward: against the JAX kernel, f32 1e-4; bf16 one bf16
step of the gradient (2^-8 relative, rtol 8e-3) plus 1e-5 for near-zero
sums, since both compute in f32 and round once at the end. Against autograd
through `reference_attention` in bf16, that path also rounds P before PV and
dP, dq, dk to bf16 on the way back: BWD_TOLS['bfloat16'] (as K2 on the card).
K2 against its plain version: |err| <= atol * max|ref| + rtol * |ref| with
BWD_TOLS; bf16 atol is twice what a CPU emulation of K2's roundings (P and
dS as bf16 operands of the products) needs at these shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.ops.attention import fused_attention as jax_fused
from vitpose_tpu.ops.attention import fused_attention_bwd as jax_fused_bwd
from vitpose_tpu.ops.attention import reference_attention as jax_reference

from vitpose_tpu_torch.ops import attention as tattn

TOLS = {'float32': dict(rtol=1e-5, atol=1e-5),
        'bfloat16': dict(rtol=1e-2, atol=4e-3)}
BWD_JAX_TOLS = {'float32': dict(rtol=1e-4, atol=1e-4),
                'bfloat16': dict(rtol=8e-3, atol=1e-5)}
BWD_TOLS = {'float32': (1e-5, 1e-5), 'bfloat16': (3e-3, 1e-2)}


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


@pytest.mark.parametrize('backward', [False, True], ids=['fwd', 'bwd'])
@pytest.mark.parametrize('d', tattn.KERNEL_HEAD_DIMS)
def test_plan_takes_the_whole_pair_at_every_vitpose_head_dim(d, backward):
    """T = 192 is every ViTPose variant at 256x192: bf16 there runs one block
    per (batch, head) pair, inside the H100's shared memory per block."""
    design, smem = tattn._plan(192, d, torch.bfloat16, backward)
    assert design == 'pair'
    assert 0 < smem <= tattn.SMEM_PER_BLOCK == 232_448


@pytest.mark.parametrize('backward', [False, True], ids=['fwd', 'bwd'])
@pytest.mark.parametrize('t,dtype', [(972, torch.bfloat16),
                                     (192, torch.float32),
                                     (tattn.PAIR_MAX_T + 1, torch.bfloat16)],
                         ids=['576x432', 'f32', 'boundary+1'])
def test_plan_takes_the_tiled_design_past_the_pair(t, dtype, backward):
    """Lengths past PAIR_MAX_T (T = 972 at 576x432 inputs, and the first
    length past the boundary) and f32 go to the tiled kernels, whose static
    tiles stay under 48 KB."""
    for d in tattn.KERNEL_HEAD_DIMS:
        design, smem = tattn._plan(t, d, dtype, backward)
        assert design == 'tiled' and 0 < smem <= 48 * 1024
    assert tattn._plan(tattn.PAIR_MAX_T, 80, torch.bfloat16,
                       backward)[0] == 'pair'


@pytest.mark.parametrize('forced', ['pair', 'flash'])
def test_forced_design_must_take_the_shape(forced):
    """The private `_design` of the wrappers may pick the tiled design at any
    shape, but never the pair design where `_plan` refuses it."""
    q = torch.zeros(1, tattn.PAIR_MAX_T + 1, 2, 64, dtype=torch.bfloat16)
    assert tattn._pick_design('k', q, False, None) == 'tiled'
    assert tattn._pick_design('k', q[:, :64], True, 'tiled') == 'tiled'
    with pytest.raises(ValueError, match='design'):
        tattn._pick_design('k', q, False, forced)


# main-path shapes, the plan's boundary (192 whole pair, 193 tiled), a ragged
# T = 72 (8 real keys in the last 64-row tile), 7 (batch, head) pairs (a
# count no tile size or block count divides) and T = 972
CARD_CASES = [
    ((2, 192, 12, 64), torch.bfloat16), ((2, 192, 12, 64), torch.float32),
    ((3, 48, 5, 32), torch.float32), ((1, 972, 2, 80), torch.bfloat16),
    ((4, 72, 12, 64), torch.bfloat16), ((3, 48, 5, 32), torch.bfloat16),
    ((2, 100, 3, 80), torch.float32), ((1, 192, 7, 80), torch.bfloat16),
    ((1, 193, 7, 64), torch.bfloat16), ((2, 130, 3, 32), torch.bfloat16)]


def _designs(shape, dtype, backward):
    """Every design that takes the shape: the tiled one always."""
    if tattn._plan(shape[1], shape[3], dtype, backward)[0] == 'pair':
        return ('tiled', 'pair')
    return ('tiled',)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,dtype', CARD_CASES)
def test_kernel_matches_plain_on_card(shape, dtype):
    """K1, in every design that takes the shape, on strided q/k/v views of
    one qkv tensor, as the ViT feeds it. T=72 leaves 8 real keys in the last
    64-key tile, so a wrong key mask moves the output far past the bf16
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: K1 has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False    # a true f32 reference
    n, t, h, d = shape
    g = torch.Generator(device='cuda').manual_seed(0)
    qkv = torch.randn(n, t, 3, h, d, generator=g, device='cuda').to(dtype)
    q, k, v = qkv.unbind(2)
    ref = tattn.reference_attention(q, k, v)
    tol = TOLS['float32' if dtype == torch.float32 else 'bfloat16']
    planned = tattn._plan(t, d, dtype)[0]
    for design in _designs(shape, dtype, False):
        before = dict(tattn.fused_attention.design_launches)
        out = tattn.fused_attention(
            q, k, v, _design=None if design == planned else design)
        torch.cuda.synchronize()
        assert tattn.fused_attention.design_launches[design] == \
            before[design] + 1
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **tol)


def _assert_bwd_close(outs, refs, dtype):
    """Each of dq, dk, dv within BWD_TOLS: atol * max|ref| + rtol * |ref|."""
    atol, rtol = BWD_TOLS[dtype]
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        assert torch.isfinite(o).all()
        bound = atol * r.abs().max() + rtol * r.abs()
        assert ((o - r).abs() <= bound).all(), (o - r).abs().max()


# (1, 48, 6, 32): 6 (batch, head) pairs, not a multiple of the JAX kernel's
# block of 8
BWD_CASES = [(shape, dtype) for shape in [(1, 48, 6, 32), (2, 40, 2, 80)]
             for dtype in ('float32', 'bfloat16')]


@pytest.fixture(scope='module')
def jax_bwd_outputs():
    """(inputs q, k, v, g and the Pallas interpret gradients) per case, from
    one JAX program."""
    inputs = [[jnp.asarray(a).astype(dtype)
               for a in _qkv(shape, sum(shape)) + _qkv(shape, 1)[:1]]
              for shape, dtype in BWD_CASES]

    def fn(inputs):
        return [jax_fused_bwd(*qkvg, interpret=True) for qkvg in inputs]

    compiled = jax.jit(fn).lower(inputs).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    return inputs, compiled(inputs)


@pytest.mark.parametrize('case', range(len(BWD_CASES)),
                         ids=[f'{s}-{d}' for s, d in BWD_CASES])
def test_plain_attention_bwd_matches_jax_and_autograd(jax_bwd_outputs, case):
    shape, dtype = BWD_CASES[case]
    inputs, outputs = jax_bwd_outputs
    tq, tk, tv, tg = (torch.from_numpy(_to_f32(a)).to(getattr(torch, dtype))
                      for a in inputs[case])
    grads = tattn.reference_attention_bwd(tq, tk, tv, tg)
    for port, ref in zip(grads, outputs[case]):
        assert port.dtype == tq.dtype and port.shape == shape
        np.testing.assert_allclose(port.float().numpy(), _to_f32(ref),
                                   **BWD_JAX_TOLS[dtype])
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    tattn.reference_attention(*leaves).backward(tg)
    if dtype == 'float32':
        for port, leaf in zip(grads, leaves):
            np.testing.assert_allclose(port.numpy(), leaf.grad.numpy(),
                                       rtol=1e-4, atol=1e-4)
    else:
        _assert_bwd_close([leaf.grad for leaf in leaves], grads, dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_differentiable_attention_on_cpu_is_the_plain_path(dtype):
    """K3 on CPU tensors: the plain forward, the plain backward, no kernel
    launch; inside no_grad it records and saves nothing."""
    shape = (2, 40, 4, 32)
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(np.stack(_qkv(shape, 3), 2)).to(dt)
    g = torch.from_numpy(_qkv(shape, 4)[0]).to(dt)
    leaf = qkv.clone().requires_grad_()
    before = (tattn.fused_attention.launches,
              tattn.fused_attention_bwd.launches)
    out = tattn.attention(*leaf.unbind(2))
    assert out.grad_fn is not None
    out.backward(g)
    assert (tattn.fused_attention.launches,
            tattn.fused_attention_bwd.launches) == before
    np.testing.assert_array_equal(
        out.detach().float().numpy(),
        tattn.reference_attention(*qkv.unbind(2)).float().numpy())
    for port, ref in zip(leaf.grad.unbind(2),
                         tattn.reference_attention_bwd(*qkv.unbind(2), g)):
        np.testing.assert_array_equal(port.float().numpy(),
                                      ref.float().numpy())
    with torch.no_grad():
        assert tattn.attention(*leaf.unbind(2)).grad_fn is None


def test_kernel_bwd_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 2, 32)
    before = tattn.fused_attention_bwd.launches
    with pytest.raises(ValueError, match='CUDA'):
        tattn.fused_attention_bwd(q, q, q, q)
    assert tattn.fused_attention_bwd.launches == before


@pytest.mark.parametrize('case', ['float16', 'head_dim_8', 'bf16_unaligned',
                                  'shape_mismatch', 'needs_grad'])
def test_kernel_bwd_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Checked before the device and before any build, so each refusal
    shows on the CPU too."""
    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    k = v = g = q
    if case == 'float16':
        q = k = v = g = q.half()
    elif case == 'head_dim_8':
        q = k = v = g = q[..., :8].contiguous()
    elif case == 'bf16_unaligned':               # token stride 36 elements
        g = torch.zeros(1, 8, 2, 36, dtype=torch.bfloat16)[..., :32]
    elif case == 'shape_mismatch':
        g = torch.zeros(1, 9, 2, 32, dtype=torch.bfloat16)
    else:
        q = q.clone().requires_grad_()
    match = {'float16': 'dtype', 'head_dim_8': 'head dim 8',
             'bf16_unaligned': 'aligned', 'shape_mismatch': 'shape',
             'needs_grad': 'gradient'}[case]
    before = tattn.fused_attention_bwd.launches
    with pytest.raises(ValueError, match=match):
        tattn.fused_attention_bwd(q, k, v, g)
    assert tattn.fused_attention_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('shape,dtype', CARD_CASES)
def test_kernel_bwd_matches_plain_on_card(shape, dtype):
    """K2, in every design that takes the shape, on strided q/k/v views of
    one qkv tensor, and K3 through the planned design."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: K2 has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False    # a true f32 reference
    n, t, h, d = shape
    gen = torch.Generator(device='cuda').manual_seed(0)
    qkv = torch.randn(n, t, 3, h, d, generator=gen, device='cuda').to(dtype)
    g = torch.randn(n, t, h, d, generator=gen, device='cuda').to(dtype)
    refs = tattn.reference_attention_bwd(*qkv.unbind(2), g)
    dtype = 'float32' if dtype == torch.float32 else 'bfloat16'
    for design in _designs(shape, qkv.dtype, True):
        before = dict(tattn.fused_attention_bwd.design_launches)
        outs = tattn.fused_attention_bwd(*qkv.unbind(2), g, _design=design)
        torch.cuda.synchronize()
        assert tattn.fused_attention_bwd.design_launches[design] == \
            before[design] + 1
        _assert_bwd_close(outs, refs, dtype)
    before = tattn.fused_attention_bwd.launches
    leaf = qkv.clone().requires_grad_()
    tattn.attention(*leaf.unbind(2)).backward(g)
    assert tattn.fused_attention_bwd.launches == before + 1
    # the planned design is the last one run above, and K2 is
    # deterministic: K3's gradients are those outputs bit for bit
    for port, ref in zip(leaf.grad.unbind(2), outs):
        assert torch.equal(port, ref)
