"""Weight carry-over from the JAX package to the port.

`state_dict_from_flax` is the exact inverse of the JAX package's
`convert_backbone`, `convert_head` and the associate-head loop of
`convert_topdown_checkpoint` (vitpose_tpu/utils/torch_ckpt.py:182-313):
it turns flax variables {'params', 'batch_stats'} (numpy arrays) into a state
dict under the mmpose names that TopDownModel uses, for the classic head (also
with the identity final layer) and the simple decoder, and for ViTPose+ the
experts (JAX's stacked `expert_kernel` [E, hidden, part] and `expert_bias`
to `mlp.experts.{e}.{weight,bias}`) and the associate heads (`extra_head_{j}`
to `associate_keypoint_heads.{j}`); variables without 'batch_stats' give a
state dict without the BN running statistics.
`load_params_npz` reads the flat 'a/b/c' .npz files that the JAX package's
`save_params_npz` writes (vitpose_tpu/utils/checkpoint.py:160-186).
"""
from __future__ import annotations

import numpy as np
import torch


def load_params_npz(path):
    """Flat 'a/b/c'-keyed .npz -> nested variables dict of numpy arrays."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split('/')
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return out


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _backbone(p):
    sd = {'patch_embed.proj.weight':
          _t(np.transpose(p['patch_embed']['kernel'], (3, 2, 0, 1))),
          'patch_embed.proj.bias': _t(p['patch_embed']['bias']),
          'pos_embed': _t(p['pos_embed'])}
    i = 0
    while f'blocks_{i}' in p:
        blk, b = p[f'blocks_{i}'], f'blocks.{i}.'
        for norm in ('norm1', 'norm2'):
            sd[b + f'{norm}.weight'] = _t(blk[norm]['scale'])
            sd[b + f'{norm}.bias'] = _t(blk[norm]['bias'])
        for group, name in (('attn', 'qkv'), ('attn', 'proj'),
                            ('mlp', 'fc1'), ('mlp', 'fc2')):
            dense = blk[group][name]
            sd[b + f'{group}.{name}.weight'] = _t(dense['kernel'].T)
            if 'bias' in dense:
                sd[b + f'{group}.{name}.bias'] = _t(dense['bias'])
        mlp = blk['mlp']
        if 'expert_kernel' in mlp:
            for e, (w, bias) in enumerate(zip(mlp['expert_kernel'],
                                              mlp['expert_bias'])):
                sd[b + f'mlp.experts.{e}.weight'] = _t(w.T)
                sd[b + f'mlp.experts.{e}.bias'] = _t(bias)
        i += 1
    sd['last_norm.weight'] = _t(p['last_norm']['scale'])
    sd['last_norm.bias'] = _t(p['last_norm']['bias'])
    return sd


def _head(p, stats):
    """HeatmapHead (deconvs, then a prediction conv unless its final layer
    is the identity) or SimpleHead (the prediction conv alone). BN running
    statistics are carried where `stats` has them."""
    sd = {}
    i = 0
    while f'deconv_{i}' in p:
        conv, bn = f'deconv_layers.{3 * i}.', f'deconv_layers.{3 * i + 1}.'
        # flax [kh, kw, out, in] -> torch ConvTranspose2d [in, out, kh, kw]
        sd[conv + 'weight'] = _t(np.transpose(p[f'deconv_{i}']['kernel'],
                                              (3, 2, 0, 1)))
        sd[bn + 'weight'] = _t(p[f'bn_{i}']['scale'])
        sd[bn + 'bias'] = _t(p[f'bn_{i}']['bias'])
        if f'bn_{i}' in stats:
            sd[bn + 'running_mean'] = _t(stats[f'bn_{i}']['mean'])
            sd[bn + 'running_var'] = _t(stats[f'bn_{i}']['var'])
            sd[bn + 'num_batches_tracked'] = torch.tensor(0)
        i += 1
    if 'final' in p:
        sd['final_layer.weight'] = _t(np.transpose(p['final']['kernel'],
                                                   (3, 2, 0, 1)))
        sd['final_layer.bias'] = _t(p['final']['bias'])
    return sd


def state_dict_from_flax(variables) -> dict:
    """flax TopDownModel variables -> {mmpose name: f32 CPU tensor}."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    sd = {f'backbone.{k}': v for k, v in _backbone(params['backbone']).items()}
    heads = [('head', 'keypoint_head')]
    j = 0
    while f'extra_head_{j}' in params:
        heads.append((f'extra_head_{j}', f'associate_keypoint_heads.{j}'))
        j += 1
    for flax_name, name in heads:
        sd.update({f'{name}.{k}': v for k, v in
                   _head(params[flax_name], stats.get(flax_name, {})).items()})
    return sd
