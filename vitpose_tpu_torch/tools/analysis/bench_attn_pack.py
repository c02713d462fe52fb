"""Does packing G (batch, head) pairs into larger GEMMs beat the batched
small GEMMs of attention, and where does K1 stand against both?

    python -m vitpose_tpu_torch.tools.analysis.bench_attn_pack [VARIANTS]
        [--shape B H S D] [--chain L] [--iters 5] [--dtype bfloat16]
        [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/bench_attn_pack.py. At the
serving shape (B, H, S, D) = (256, 12, 192, 64) bf16, each arm is applied
L = 12 times in a chain per timed call: its output, divided by max|o| +
1e-3, is the next q and is added (times 1e-3) to k and v. VARIANTS is JAX's
comma-separated list of arms (JAX's names `xla_sdpa` and `pallas` are taken
for `sdpa` and `fused`):

  base       the plain batched attention: QK^T as one bmm in the input
             dtype, softmax in f32, P cast to the input dtype, PV as one
             bmm. JAX keeps S in f32 (preferred_element_type); here the
             bmm rounds S to the input dtype at its output (cuBLAS
             accumulates in f32), and scale and softmax run on its f32 copy
  sdpa       torch's F.scaled_dot_product_attention, JAX's xla_sdpa: a
             comparison arm only, on no model path. torch takes [B, H, S,
             D] as it is, so this arm has no transposes
  fused      K1 (`vitpose::attention_fwd`, JAX's pallas), which takes
             [N, T, H, d]: the transposes are views (strides in multiples
             of 8 elements are what its wrapper asks), no copy is made in
             or out of the timed window; 12 launches a timed call
  packG      QK^T of G pairs as one [G S, D] x [D, G S] bmm, whose G
             diagonal [S, S] blocks are kept (torch.diagonal, a view, where
             JAX contracts with the identity: the same values), PV batched
  packG_full also PV as one block-diagonal [G S, G S] x [G S, D] bmm

with G in 2, 4, 8 for packG and 2, 4 for packG_full, S of the packed arms
handled as in base. The ITERS + 1 input triples are drawn on the card
before any timing (about 1.36 GB at the serving shape); each arm's first
call is a warm-up and the median of the other ITERS calls, each between
CUDA events (the host clock on the CPU), is printed with the useful
TFLOP/s (QK^T and PV only) beside the card's name and power limit. JAX
syncs on a host readback of the chain's sum; this reads nothing back.
"""
from __future__ import annotations

import argparse
import functools

import torch
import torch.nn.functional as F

from ...api.inference import _device
from ...ops.attention import attention
from ._common import Launches, timed_ms, where

ALIASES = {'xla_sdpa': 'sdpa', 'pallas': 'fused'}


def base_core(q, k, v):
    """Plain attention on [B, H, S, D]: bmm, f32 softmax, bmm."""
    b, h, s, d = q.shape
    sc = torch.bmm(q.reshape(b * h, s, d),
                   k.reshape(b * h, s, d).transpose(1, 2)).float() * d ** -0.5
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.bmm(p, v.reshape(b * h, s, d)).view(b, h, s, d)


def sdpa_core(q, k, v):
    return F.scaled_dot_product_attention(q, k, v)


def fused_core(q, k, v):
    """K1 through the custom op (the plain version on the CPU), on
    [B, S, H, D] views of the [B, H, S, D] inputs."""
    return attention(q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2)).transpose(1, 2)


def pack_core(q, k, v, g, full):
    """G-packed QK^T with its diagonal blocks; PV batched per pair or, with
    `full`, as one block-diagonal product per pack."""
    b, h, s, d = q.shape
    n = b * h // g
    qm, km, vm = (x.reshape(n, g * s, d) for x in (q, k, v))
    full_s = torch.bmm(qm, km.transpose(1, 2)).float() * d ** -0.5
    # [n, g, s, g, s] -> the g diagonal blocks, [n, g, s, s]
    diag = torch.diagonal(full_s.view(n, g, s, g, s), dim1=1,
                          dim2=3).permute(0, 3, 1, 2)
    p = torch.softmax(diag, dim=-1).to(q.dtype)
    if full:
        eye = torch.eye(g, dtype=p.dtype, device=p.device)
        pbd = (p.unsqueeze(3) * eye.view(1, g, 1, g, 1)).reshape(
            n, g * s, g * s)
        return torch.bmm(pbd, vm).view(b, h, s, d)
    return torch.matmul(p, vm.view(n, g, s, d)).view(b, h, s, d)


def variants():
    """[(name, core)] in JAX's order."""
    out = [('base', base_core), ('sdpa', sdpa_core), ('fused', fused_core)]
    out += [(f'pack{g}', functools.partial(pack_core, g=g, full=False))
            for g in (2, 4, 8)]
    out += [(f'pack{g}_full', functools.partial(pack_core, g=g, full=True))
            for g in (2, 4)]
    return out


def chained(core, length):
    """run(q, k, v): `length` applications of `core`, each output
    renormalised by its max |o| and fed forward as q (and into k and v);
    returns the f32 sum of the last output."""
    def run(q, k, v):
        for _ in range(length):
            o = core(q, k, v)
            o = o / (o.abs().max() + 1e-3)
            q, k, v = o, k + o * 1e-3, v + o * 1e-3
        return o.float().sum()
    return run


def main(argv=None):
    """Print one line per arm; returns {name: {'ms', 'tflops',
    'launches'}}."""
    ap = argparse.ArgumentParser(description='G-packed attention GEMMs '
                                 'against the batched ones and K1 (PyTorch '
                                 'port)')
    ap.add_argument('variants', nargs='?', default='',
                    help='comma-separated arms (default: all)')
    ap.add_argument('--shape', type=int, nargs=4, default=(256, 12, 192, 64),
                    metavar=('B', 'H', 'S', 'D'))
    ap.add_argument('--chain', type=int, default=12)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    dtype = getattr(torch, args.dtype)
    b, h, s, d = args.shape
    arms = variants()
    if args.variants:
        want = {ALIASES.get(n, n) for n in args.variants.split(',')}
        unknown = want - {n for n, _ in arms}
        if unknown:
            raise ValueError(f'unknown arms {sorted(unknown)}; the arms are '
                             f'{[n for n, _ in arms]}')
        arms = [a for a in arms if a[0] in want]

    flops_useful = 2 * 2 * b * h * s * s * d * args.chain
    print(f'shape B{b} H{h} S{s} D{d}, L={args.chain} chained, '
          f'{args.dtype}; useful {flops_useful / 1e12:.2f} TFLOP/dispatch')
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = [tuple(torch.randn((b, h, s, d), generator=gen, device=dev,
                                dtype=dtype) for _ in range(3))
              for _ in range(args.iters + 1)]
    out = {}
    for name, core in arms:
        run = chained(core, args.chain)
        with Launches() as counted, torch.inference_mode():
            ms = timed_ms(lambda qkv: run(*qkv), inputs, args.iters + 1, dev)
        dt = sorted(ms[1:])[len(ms[1:]) // 2]
        tflops = flops_useful / dt / 1e9
        print(f'{name:12s} {dt:8.2f} ms/dispatch   {tflops:6.1f} '
              f'useful-TFLOP/s {where(dev)}', flush=True)
        out[name] = {'ms': dt, 'tflops': tflops,
                     'launches': counted.counts()}
    return out


if __name__ == '__main__':
    main()
