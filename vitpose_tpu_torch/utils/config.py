"""Config system: Python-file configs with `_base_` composition and dotted
CLI overrides.

The port's own copy of vitpose_tpu/utils/config.py:17-71 (`_deep_merge`,
`load_config`, `apply_options`): the same `_base_` composition, `_delete_`
marker and `--cfg-options` parsing, so a config file of the zoo loads to the
same dict in both packages. Config files are plain Python executed in an empty
namespace; every UPPER- or lower-case top-level variable that doesn't start
with '_' becomes a key. `_base_` is a list of paths relative to the file.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, List


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict):
            # strip the mmcv-style _delete_ marker unconditionally (it
            # must never leak into the merged config, even when the base
            # lacks the key) and without mutating the caller's dict
            delete = bool(v.get('_delete_', False))
            if '_delete_' in v:
                v = {kk: vv for kk, vv in v.items() if kk != '_delete_'}
            if k in out and isinstance(out[k], dict) and not delete:
                out[k] = _deep_merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    ns: Dict[str, Any] = {'__file__': path}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, 'exec'), ns)
    cfg = {k: v for k, v in ns.items()
           if not k.startswith('_') and k != 'os'
           and not callable(v) and not isinstance(v, type(os))}
    bases = ns.get('_base_', [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        bpath = os.path.join(os.path.dirname(path), b)
        merged = _deep_merge(merged, load_config(bpath))
    return _deep_merge(merged, cfg)


def apply_options(cfg: dict, options: List[str]) -> dict:
    """Apply 'a.b.c=value' dotted overrides (values parsed as Python
    literals when possible)."""
    import ast
    cfg = copy.deepcopy(cfg)
    for opt in options or []:
        key, _, raw = opt.partition('=')
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = cfg
        parts = key.split('.')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg
