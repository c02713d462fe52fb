"""Fused multi-head self-attention: the K1 (forward) and K2 (backward) CUDA
kernels, their plain PyTorch versions and the differentiable K3.

Counterpart of vitpose_tpu/ops/attention.py (the Pallas `_attn_kernel` and
`_attn_bwd_kernel`, `reference_attention` and the `attention` custom_vjp).
Layout is [N, T, H, d] for q, k, v, the output and its gradients, as in the
JAX package.

  * ``reference_attention`` -- plain PyTorch, following the TPU forward
    kernel's arithmetic: scores in f32, softmax in f32, P cast to v's dtype,
    PV accumulated in f32, output cast to the input dtype.
  * ``reference_attention_bwd`` -- plain PyTorch, following the TPU backward
    kernel's arithmetic: every step in f32 with normalised f32 P, the
    gradients cast to the input dtype.
  * ``fused_attention`` / ``fused_attention_bwd`` -- launch the hand-written
    sm_90a kernels (csrc/attention_fwd.cu, csrc/attention_bwd.cu: tensor
    cores for bf16, CUDA cores for f32) on CUDA tensors, and raise on
    anything else or on any launch failure. ``_plan`` picks each call's
    design from its shape: 'pair' (one block per (batch, head) pair, inputs
    read once by TMA; bf16 up to T = 192) or 'tiled' (any T, and f32). Each
    wrapper has a ``launches`` attribute that counts its calls and a
    ``design_launches`` dict that counts them per design. Neither takes
    part in autograd.
  * ``attention`` -- what the ViT calls (K3): the kernels for CUDA tensors,
    the plain versions for CPU tensors, decided by the device alone. When a
    gradient is wanted it is a ``torch.autograd.Function`` that saves q, k, v
    (as the JAX custom_vjp does) and runs the backward; otherwise it saves
    nothing and runs the forward only.
"""
from __future__ import annotations

import ctypes

import torch

# head dims that csrc/attention_{fwd,bwd}.cu instantiate: ViTPose S (32),
# B and L (64), H (80)
KERNEL_HEAD_DIMS = (32, 64, 80)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DESIGN_CODE = {'tiled': 0, 'pair': 1}
# the whole-pair designs give each 64 rows of a pair one warpgroup and hold
# a warpgroup's [64, T] scores in registers: at most three warpgroups
PAIR_MAX_T = 192
SMEM_PER_BLOCK = 232_448          # shared memory one H100 block may use
_MAP_ERROR = 1000                 # csrc/hopper.cuh kMapError


def _plan(t, d, dtype, backward=False):
    """(design, shared-memory bytes of one block) of K1, or of K2 when
    `backward`, for [N, t, H, d] inputs of `dtype`.

    'pair' (one block per (batch, head) pair) takes bf16 up to PAIR_MAX_T
    tokens when its tiles fit in SMEM_PER_BLOCK: K1 two stages of q, k, v
    and the output tile; K2 q, k, v, g, the bf16 [T, T] dS tile and two f32
    row statistics; both padded to 64 rows, plus 1024 bytes of alignment
    and the barriers (csrc `pair_smem` gives the same numbers). 'tiled'
    takes every other length and f32, in 64-row tiles of static shared
    memory.
    """
    rows = -(-t // 64) * 64
    if backward:
        pair = 1024 + 4 * rows * d * 2 + rows * rows * 2 + 2 * rows * 4 + 8
    else:
        pair = 1024 + 7 * rows * d * 2 + 16
    if dtype == torch.bfloat16 and t <= PAIR_MAX_T and pair <= SMEM_PER_BLOCK:
        return 'pair', pair
    if dtype == torch.bfloat16:     # three tiles, rows padded by 8 elements
        return 'tiled', 3 * 64 * (d + 8) * 2
    # two f32 tiles, and K2's key pass two rows of statistics
    return 'tiled', 2 * 64 * d * 4 + (2 * 64 * 4 if backward else 0)


def reference_attention(q, k, v, scale=None):
    """Plain attention, [N, T, H, d] -> [N, T, H, d], in the kernel's math."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum('nqhd,nkhd->nhqk', q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum('nhqk,nkhd->nqhd', p.float(), v.float())
    return o.to(q.dtype)


def reference_attention_bwd(q, k, v, g, scale=None):
    """Plain attention backward, (q, k, v, dO) [N, T, H, d] -> (dq, dk, dv),
    in the TPU backward kernel's math (vitpose_tpu/ops/attention.py:94)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    p = torch.softmax(torch.einsum('nqhd,nkhd->nhqk', qf, kf) * scale, -1)
    dv = torch.einsum('nhqk,nqhd->nkhd', p, gf)
    dp = torch.einsum('nqhd,nkhd->nhqk', gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum('nhqk,nkhd->nqhd', ds, kf) * scale
    dk = torch.einsum('nhqk,nqhd->nkhd', ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(fn, **tensors):
    """Refuse what the kernels of `fn` do not take, before any build or
    launch: tensors share one [N, T, H, d] shape, dtype and device; last dim
    contiguous; bf16 rows 16-byte aligned; d built; CUDA."""
    q = next(iter(tensors.values()))
    for name, x in tensors.items():
        if x.dtype not in _DTYPE_CODE:
            raise ValueError(f'{fn}: {name} has dtype {x.dtype}; the kernel '
                             'takes float32 or bfloat16')
        if x.dim() != 4 or x.shape != q.shape:
            raise ValueError(f'{fn}: {", ".join(tensors)} must share one '
                             '[N, T, H, d] shape, got '
                             f'{[tuple(t.shape) for t in tensors.values()]}')
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f'{fn}: {", ".join(tensors)} must share dtype '
                             'and device')
        if x.stride(-1) != 1:
            raise ValueError(f'{fn}: {name} must be contiguous in its last '
                             f'dim, got strides {x.stride()}')
        # the tensor cores load 16-byte rows: 8 bf16 elements
        if x.dtype == torch.bfloat16 and (
                x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3])):
            raise ValueError(f'{fn}: bf16 {name} needs 16-byte aligned rows '
                             '(base on 16 bytes, strides in multiples of 8), '
                             f'got strides {x.stride()}')
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError(f'{fn} launches a kernel and records no '
                             'gradient; call attention() to differentiate')
    n, t, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f'{fn}: head dim {d} is not built; the kernel takes '
                         f'{KERNEL_HEAD_DIMS}')
    # the grids have one block per (pair, 64-row tile)
    if min(n, t, h) < 1 or n * h * -(-t // 64) >= 2 ** 31:
        raise ValueError(f'{fn}: bad shape {tuple(q.shape)}')
    if q.device.type != 'cuda':
        raise ValueError(f'{fn}: the inputs are on {q.device}; the kernel '
                         'takes CUDA tensors only')


def _kernel_fn(name, n_ptrs):
    """The C entry point vtp_<name> of csrc/<name>.cu: `n_ptrs` pointers,
    n, t, h, d, dtype, design, the strides, the scale and the stream."""
    from ..kernels import _build
    fn = getattr(_build.load(name), f'vtp_{name}')
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(name, tensors, outputs, design, scale):
    """Call vtp_<name> on `tensors` (inputs, [N, T, H, d] views) and
    `outputs` (tensors it writes, or None for a null pointer) on the
    current stream; raise on error."""
    n, t, h, d = tensors[0].shape
    dtype = tensors[0].dtype
    fn = _kernel_fn(name, len(tensors) + len(outputs))
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *[st for x in tensors for st in x.stride()[:3]])
    ptrs = [None if x is None else x.data_ptr() for x in tensors + outputs]
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, n, t, h, d, _DTYPE_CODE[dtype], _DESIGN_CODE[design],
                 strides, float(scale), stream)
    if err >= _MAP_ERROR:
        raise RuntimeError(f'{name} ({design}): cuTensorMapEncodeTiled refused a TMA '
                           f'tensor map (CUresult {err - _MAP_ERROR}) at '
                           f'shape {(n, t, h, d)} {dtype}')
    if err != 0:
        raise RuntimeError(f'{name} ({design}) launch failed with CUDA error '
                           f'{err} at shape {(n, t, h, d)} {dtype}')


def _pick_design(fn, q, backward, forced):
    """The design `_plan` picks for q's shape and dtype, or `forced`
    ('tiled' or 'pair') where that design takes them."""
    n, t, h, d = q.shape
    planned, _ = _plan(t, d, q.dtype, backward)
    if forced is None:
        return planned
    if forced not in _DESIGN_CODE or (forced == 'pair' and planned != 'pair'):
        raise ValueError(f'{fn}: design {forced!r} does not take shape '
                         f'{tuple(q.shape)} {q.dtype}; _plan gives '
                         f'{planned!r}')
    return forced


def fused_attention(q, k, v, scale=None, _design=None):
    """K1: [N, T, H, d] float32/bfloat16 CUDA tensors -> [N, T, H, d].

    q, k and v may be strided views (last dim contiguous); the output is a new
    contiguous tensor. Launches on the current stream and raises if the
    launch fails. `_design` forces a design ('tiled' or 'pair') where the
    shape allows it, so that one can be timed against the other.
    """
    _check_kernel_inputs('fused_attention', q=q, k=k, v=v)
    design = _pick_design('fused_attention', q, False, _design)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch('attention_fwd', [q, k, v], [out], design, scale)
    fused_attention.launches += 1
    fused_attention.design_launches[design] += 1
    return out


fused_attention.launches = 0
fused_attention.design_launches = {'pair': 0, 'tiled': 0}


def fused_attention_bwd(q, k, v, g, scale=None, _design=None):
    """K2: (q, k, v, dO) [N, T, H, d] float32/bfloat16 CUDA tensors ->
    (dq, dk, dv).

    Inputs may be strided views (last dim contiguous); dq, dk, dv are new
    contiguous tensors. The whole-pair design is one launch with nothing in
    device memory but inputs and outputs; the tiled design's first pass
    writes the softmax row statistics (log-sum-exp and rowsum(dP o P), f32
    [N*H, T] each) to scratch that its second pass reads. Launches on the
    current stream and raises if a launch fails. `_design` as in
    `fused_attention`.
    """
    _check_kernel_inputs('fused_attention_bwd', q=q, k=k, v=v, g=g)
    design = _pick_design('fused_attention_bwd', q, True, _design)
    n, t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
             for _ in range(3)]
    if design == 'tiled':
        stats = list(torch.empty((2, n * h, t), dtype=torch.float32,
                                 device=q.device))
    else:
        stats = [None, None]
    _launch('attention_bwd', [q, k, v, g], grads + stats, design, scale)
    fused_attention_bwd.launches += 1
    fused_attention_bwd.design_launches[design] += 1
    return tuple(grads)


fused_attention_bwd.launches = 0
fused_attention_bwd.design_launches = {'pair': 0, 'tiled': 0}


def _forward(q, k, v):
    if q.device.type == 'cpu':
        return reference_attention(q, k, v)
    return fused_attention(q, k, v)


class _Attention(torch.autograd.Function):
    """K3: K1 forward and K2 backward on CUDA, the plain versions on the
    CPU; saves q, k, v as the JAX custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.contiguous()
        if q.device.type == 'cpu':
            return reference_attention_bwd(q, k, v, g)
        return fused_attention_bwd(q, k, v, g)


def attention(q, k, v):
    """Attention core of the ViT: the kernels on CUDA, the plain versions on
    the CPU; differentiable (K3) when a gradient is wanted."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v)
    return _forward(q, k, v)
