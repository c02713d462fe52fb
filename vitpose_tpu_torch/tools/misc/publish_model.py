"""Prepare a checkpoint for publishing: weights only, under the mmpose names.

    python -m vitpose_tpu_torch.tools.misc.publish_model IN_CKPT OUT.pth \
        [--config CONFIG.py]

Counterpart of the JAX package's tools/misc/publish_model.py (reference
tools/misc/publish_model.py). IN_CKPT is the training runner's
`epoch_{e}.pth` (its optimizer and scheduler state, step and epoch are
dropped), a plain state dict (`best.pth`, or a reference .pth in a
{'state_dict' | 'model'} container), or, with `--config`, anything the
config's model loads through `api.inference.load_checkpoint`: the JAX
package's flat params .npz (carried over by utils/convert.py) or a
reference .pth whose pos embed is regridded. With `--config` the weights
are loaded into the config's model, strictly, and its state dict is what
is written.

The output is a plain state dict `.pth`, the format of `best.pth` that
both packages' `init_pose_model` read, renamed to
`{stem}-{sha256[:8]}_{YYYYMMDD}.pth` after the sha256 of its bytes and
today's date, as JAX's tool stamps its .npz (JAX :56-60).
"""
from __future__ import annotations

import argparse
import hashlib
import os
from datetime import date

import torch

from ...api.inference import load_checkpoint
from ...train.loop import build_model_from_cfg
from ...utils.config import load_config


def _state_dict(in_file, config=None):
    """{name: tensor} of the weights in `in_file` (see the module
    docstring)."""
    if config:
        model = build_model_from_cfg(load_config(config)['model'])
        load_checkpoint(model, in_file)
        return model.state_dict()
    if not in_file.endswith('.pth'):
        raise ValueError(f'{in_file}: without --config publish_model takes '
                         'a .pth; a JAX .npz needs the config whose model '
                         'it holds (--config CONFIG.py)')
    ckpt = torch.load(in_file, map_location='cpu', weights_only=True)
    for key in ('model', 'state_dict'):
        if isinstance(ckpt.get(key), dict):
            return ckpt[key]
    return ckpt


def process_checkpoint(in_file, out_file, config=None):
    """Write the published state dict; returns its final path."""
    sd = {k: v.detach().cpu() for k, v in _state_dict(in_file,
                                                       config).items()}
    torch.save(sd, out_file)
    with open(out_file, 'rb') as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    stem = out_file[:-4] if out_file.endswith('.pth') else out_file
    final_file = f'{stem}-{sha[:8]}_{date.today().strftime("%Y%m%d")}.pth'
    os.replace(out_file, final_file)
    print(f'published {final_file}')
    return final_file


def main(argv=None):
    ap = argparse.ArgumentParser(description='Strip a checkpoint to its '
                                 'weights for publishing (PyTorch port)')
    ap.add_argument('in_file')
    ap.add_argument('out_file')
    ap.add_argument('--config', default=None,
                    help='the model config; needed for a JAX .npz')
    args = ap.parse_args(argv)
    return process_checkpoint(args.in_file, args.out_file,
                              config=args.config)


if __name__ == '__main__':
    main()
