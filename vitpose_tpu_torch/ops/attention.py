"""Fused multi-head self-attention forward: the K1 CUDA kernel and its plain
PyTorch version.

Counterpart of vitpose_tpu/ops/attention.py (the Pallas forward `_attn_kernel`
and `reference_attention`). Layout is [N, T, H, d] for q, k, v and the
output, as in the JAX package.

  * ``reference_attention`` -- plain PyTorch, following the TPU kernel's
    arithmetic: scores in f32, softmax in f32, P cast to v's dtype, PV
    accumulated in f32, output cast to the input dtype.
  * ``fused_attention`` -- launches the hand-written sm_90a kernel
    (csrc/attention_fwd.cu: tensor cores for bf16, CUDA cores for f32) on a
    CUDA tensor, and raises on anything else or on any launch failure. Its
    ``launches`` attribute counts launches.
  * ``attention`` -- what the ViT calls: the kernel for a CUDA tensor, the
    plain version for a CPU tensor, decided by the tensor's device alone.

Forward only: the backward kernel (K2) and the autograd wrapper (K3) are
still to port, so ``fused_attention`` refuses inputs that need a gradient.
"""
from __future__ import annotations

import ctypes

import torch

# head dims that csrc/attention_fwd.cu instantiates: ViTPose S (32),
# B and L (64), H (80)
KERNEL_HEAD_DIMS = (32, 64, 80)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, scale=None):
    """Plain attention, [N, T, H, d] -> [N, T, H, d], in the kernel's math."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum('nqhd,nkhd->nhqk', q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum('nhqk,nkhd->nqhd', p.float(), v.float())
    return o.to(q.dtype)


def _check_kernel_inputs(q, k, v):
    for name, x in (('q', q), ('k', k), ('v', v)):
        if x.dtype not in _DTYPE_CODE:
            raise ValueError(f'fused_attention: {name} has dtype {x.dtype}; '
                             'the kernel takes float32 or bfloat16')
        if x.dim() != 4 or x.shape != q.shape:
            raise ValueError('fused_attention: q, k, v must share one '
                             f'[N, T, H, d] shape, got {tuple(q.shape)}, '
                             f'{tuple(k.shape)}, {tuple(v.shape)}')
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError('fused_attention: q, k, v must share dtype and '
                             'device')
        if x.stride(-1) != 1:
            raise ValueError(f'fused_attention: {name} must be contiguous in '
                             f'its last dim, got strides {x.stride()}')
        # the tensor cores load 16-byte rows: 8 bf16 elements
        if x.dtype == torch.bfloat16 and (
                x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3])):
            raise ValueError(f'fused_attention: bf16 {name} needs 16-byte '
                             'aligned rows (base on 16 bytes, strides in '
                             f'multiples of 8), got strides {x.stride()}')
        if x.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                'fused_attention is forward only: the backward kernel (K2) '
                'and its autograd wrapper (K3) are not ported yet '
                '(ROADMAP.md queue 2)')
    n, t, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f'fused_attention: head dim {d} is not built; the '
                         f'kernel takes {KERNEL_HEAD_DIMS}')
    # the grid has one block per (pair, 64-query tile)
    if min(n, t, h) < 1 or n * h * -(-t // 64) >= 2 ** 31:
        raise ValueError(f'fused_attention: bad shape {tuple(q.shape)}')
    if q.device.type != 'cuda':
        raise ValueError(f'fused_attention: the inputs are on {q.device}; '
                         'the kernel takes CUDA tensors only')


def _kernel_fn():
    from ..kernels import _build
    lib = _build.load('attention_fwd')
    fn = lib.vtp_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_attention(q, k, v, scale=None):
    """K1: [N, T, H, d] float32/bfloat16 CUDA tensors -> [N, T, H, d].

    q, k and v may be strided views (last dim contiguous); the output is a new
    contiguous tensor. Launches on the current stream and raises if the
    launch fails.
    """
    _check_kernel_inputs(q, k, v)
    n, t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    fn = _kernel_fn()
    out = torch.empty((n, t, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 n, t, h, d, _DTYPE_CODE[q.dtype], strides, float(scale),
                 stream)
    if err != 0:
        raise RuntimeError(f'attention_fwd launch failed with CUDA error '
                           f'{err} at shape {tuple(q.shape)} {q.dtype}')
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def attention(q, k, v):
    """Attention core of the ViT: K1 on CUDA, the plain version on the CPU."""
    if q.device.type == 'cpu':
        return reference_attention(q, k, v)
    return fused_attention(q, k, v)
