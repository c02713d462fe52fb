"""Model export for deployment: the serving function as a `torch.export`
program, saved, reloaded and checked against the eager model.

    python -m vitpose_tpu_torch.tools.export CONFIG --out model.pt2
        [--checkpoint x.pth|x.npz] [--format pt2|savedmodel] [--batch 1]
        [--no-flip] [--device cuda|cpu]

Counterpart of tools/deployment/export.py, with its flags and defaults plus
`--device` (CUDA by default; it raises without CUDA). What is exported is
`infer(model, imgs, flip_index=...)` on NHWC float32 crops (batch, H, W, 3),
as JAX exports its `fwd`. `--format pt2` (the default) is the counterpart of
JAX's `stablehlo`: PyTorch's own serialised program (an ExportedProgram in a
.pt2 archive, not StableHLO); it holds K1 as `vitpose.attention_fwd`.
`--format savedmodel` needs TensorFlow and is refused.

A .pt2 file names the `vitpose::` ops, so it loads only after
`vitpose_tpu_torch.ops.attention` has registered them: `load_exported`
imports them first.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.nn as nn

from ..api.inference import init_pose_model
from ..models.topdown import infer
from ..ops import attention  # noqa: F401  (registers the vitpose:: ops)


class InferModule(nn.Module):
    """`infer(model, imgs, flip_index)` as a module, the flip permutation a
    buffer (None: no flip test), so that export lifts it with the
    weights."""

    def __init__(self, model, flip_index=None):
        super().__init__()
        self.model = model
        self.register_buffer('flip_index', flip_index)

    def forward(self, imgs):
        return infer(self.model, imgs, flip_index=self.flip_index)


def export_program(module: nn.Module, example):
    """`torch.export.export` of `module` on `example` (a tensor) under
    no_grad, so that no op records a gradient."""
    with torch.no_grad():
        return torch.export.export(module, (example,))


def load_exported(path):
    """The ExportedProgram saved at `path`, after the `vitpose::` ops it
    names are registered (this module imports them)."""
    return torch.export.load(path)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='Export a top-down pose model '
                                 '(PyTorch port)')
    ap.add_argument('config')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--out', required=True)
    ap.add_argument('--format', default='pt2', choices=['pt2', 'savedmodel'],
                    help="'pt2': torch.export's serialised program (the "
                         "counterpart of JAX's stablehlo; not StableHLO "
                         "itself); 'savedmodel' needs TensorFlow")
    ap.add_argument('--batch', type=int, default=1)
    ap.add_argument('--no-flip', action='store_true')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    """Export, save, reload and call on the same input; returns
    (the reloaded ExportedProgram, the max abs reload parity error)."""
    args = parse_args(argv)
    if args.format == 'savedmodel':
        raise NotImplementedError(
            '--format savedmodel needs TensorFlow (jax2tf in the JAX '
            'package), which the card machine does not have (ROADMAP.md, '
            '"Not queued"); use --format pt2')
    pm = init_pose_model(args.config, checkpoint=args.checkpoint,
                         device=args.device)
    flip = None if args.no_flip else pm.flip_index_tensor()
    module = InferModule(pm.model, flip).eval()
    ih, iw = pm.cfg.backbone.img_size
    x = torch.randn((args.batch, ih, iw, 3),
                    generator=torch.Generator().manual_seed(0))
    x = x.to(pm.device)
    with torch.no_grad():
        ref = module(x)
    torch.export.save(export_program(module, x), args.out)
    reloaded = load_exported(args.out)
    with torch.no_grad():
        out = reloaded.module()(x)
    err = (out - ref).abs().max().item()
    print(f'wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB), '
          f'reload parity max err {err:.2e}', flush=True)
    return reloaded, err


if __name__ == '__main__':
    main()
