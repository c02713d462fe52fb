"""Parameters and FLOPs of a config's model.

    python -m vitpose_tpu_torch.tools.analysis.get_flops CONFIG
        [--shape H W] [--cfg-options ...] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/get_flops.py (reference
tools/analysis/get_flops.py). One forward of a zero batch of one crop in
eval mode under torch.utils.flop_counter.FlopCounterMode: it counts the
products, 2 FLOPs per multiply-add, of the linear layers, the convolutions
(transposed ones included) and, through the formula that
`ops.attention.register_flop_formulas` gives the custom op
`vitpose::attention_fwd` (whose inside the counter cannot see), attention's
QK^T and PV. Elementwise work (norms, GELU, softmax, BN) is not counted;
JAX's figure is XLA's cost analysis of the compiled program, which counts
it, so the two differ by that work.
"""
from __future__ import annotations

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from ...ops.attention import register_flop_formulas
from ._common import config_model, input_size, where


def count_flops(model, x):
    """(total FLOPs, {op name: FLOPs}) of model(x) in eval mode."""
    register_flop_formulas()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    per_op = {str(op): n for op, n in
              counter.get_flop_counts().get('Global', {}).items()}
    return counter.get_total_flops(), per_op


def main(argv=None):
    """Print and return {'params', 'flops', 'per_op', 'shape'}."""
    ap = argparse.ArgumentParser(description='Parameters and FLOPs of a '
                                 "config's model (PyTorch port)")
    ap.add_argument('config')
    ap.add_argument('--shape', type=int, nargs=2, default=None,
                    help='input H W (default: the config image size)')
    ap.add_argument('--cfg-options', nargs='*', default=[])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)

    _, model = config_model(args.config, args.device, args.cfg_options)
    ih, iw = args.shape or input_size(model)
    x = torch.zeros(1, ih, iw, 3, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    flops, per_op = count_flops(model, x)
    print(f'input shape : (1, {ih}, {iw}, 3)')
    print(f'params      : {n_params / 1e6:.2f} M')
    print(f'flops       : {flops / 1e9:.2f} GFLOPs (products of the linear '
          'layers, convolutions and attention; 2 per multiply-add), '
          f'counted {where(args.device)}')
    for op, n in sorted(per_op.items(), key=lambda kv: -kv[1]):
        print(f'  {op:32s} {n / 1e9:.3f} GFLOPs')
    return {'params': n_params, 'flops': flops, 'per_op': per_op,
            'shape': (1, ih, iw, 3)}


if __name__ == '__main__':
    main()
