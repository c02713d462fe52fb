"""Print a fully resolved config.

    python -m vitpose_tpu_torch.tools.analysis.print_config CONFIG \
        [--cfg-options k=v ...]

The port's copy of the JAX package's tools/analysis/print_config.py
(reference tools/analysis/print_config.py): the config with its `_base_`
files merged and the options applied, by the port's `utils/config.py`,
pretty-printed 100 columns wide; the same text as JAX's.
"""
from __future__ import annotations

import argparse
import pprint

from ...utils.config import apply_options, load_config


def main(argv=None):
    """Print the config; returns it."""
    ap = argparse.ArgumentParser(description='Print a resolved config')
    ap.add_argument('config')
    ap.add_argument('--cfg-options', nargs='*', default=[])
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    if args.cfg_options:
        cfg = apply_options(cfg, args.cfg_options)
    pprint.pprint(cfg, width=100)
    return cfg


if __name__ == '__main__':
    main()
