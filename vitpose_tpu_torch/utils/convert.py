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
`cnn_state_dict_from_flax` is the exact inverse of the JAX package's CNN
converters that `convert_generic_topdown_checkpoint` runs
(vitpose_tpu/utils/cnn_ckpt.py:124-186 `convert_resnext`, the `resnet`,
`resnext`, `seresnet` and `seresnext` one with the SE layer's 1x1 convs,
`convert_hrnet`, also the `hrnetv2` one, `convert_scnet` :189,
`convert_vipnas_mbv3` :280 (its flat `layer{n}` numbering),
`convert_vipnas_resnet` :303 (mmpose's LayerNorm([planes, 1, 1]));
vitpose_tpu/models/resnet.py:159 `convert_resnet_checkpoint`, the
`resnet_v1d` one) and of `convert_head` with its extra convs and
`convert_vipnas_head` (:685, the grouped deconvs' flax ConvTransposes
stacked along `in`), for GenericTopDown's mmpose names. The JAX package
has no converter for the FLAX_NAMED_BACKBONES: the port names their
modules after the flax paths (`_CNN_MODULES`), one entry per flax leaf,
Dense kernels as nn.Linear weights.
`bottomup_state_dict_from_flax` does the same for JAX's BottomUpEstimator
variables: the ViT or CNN backbone and both AE heads (the inverse of
vitpose_tpu/utils/family_ckpt.py:102 `convert_bottomup_checkpoint`).
`load_params_npz` reads the flat 'a/b/c' .npz files that the JAX package's
`save_params_npz` writes (vitpose_tpu/utils/checkpoint.py:160-186).
"""
from __future__ import annotations

import re

import numpy as np
import torch

# the backbones whose modules take the flax names, for want of a JAX
# converter from mmpose's: a reference mmpose .pth of them does not load
FLAX_NAMED_BACKBONES = ('resnest', 'vgg', 'alexnet', 'shufflenet_v1',
                        'regnet', 'mobilenet_v3')
CNN_BACKBONES = ('resnet', 'resnet_v1d', 'hrnet', 'hrnetv2', 'resnext',
                 'seresnet', 'seresnext', 'scnet', 'vipnas_resnet',
                 'vipnas_mbv3') + FLAX_NAMED_BACKBONES


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
    while f'deconv_{i}' in p or f'deconv_{i}_0' in p:
        conv, bn = f'deconv_layers.{3 * i}.', f'deconv_layers.{3 * i + 1}.'
        # flax [kh, kw, out, in] -> torch ConvTranspose2d [in, out, kh, kw];
        # the ViPNAS head's g flax ConvTransposes `deconv_{i}_{gi}` stack
        # along `in` into one grouped ConvTranspose2d [in, out / g, kh, kw]
        kernels = [p[f'deconv_{i}']['kernel']] if f'deconv_{i}' in p else []
        while f'deconv_{i}_{len(kernels)}' in p:
            kernels.append(p[f'deconv_{i}_{len(kernels)}']['kernel'])
        sd[conv + 'weight'] = _t(np.concatenate(
            [np.transpose(k, (3, 2, 0, 1)) for k in kernels]))
        sd[bn + 'weight'] = _t(p[f'bn_{i}']['scale'])
        sd[bn + 'bias'] = _t(p[f'bn_{i}']['bias'])
        if f'bn_{i}' in stats:
            sd[bn + 'running_mean'] = _t(stats[f'bn_{i}']['mean'])
            sd[bn + 'running_var'] = _t(stats[f'bn_{i}']['var'])
            sd[bn + 'num_batches_tracked'] = torch.tensor(0)
        i += 1
    # extra convs (HRNetV2 heads): final_layer becomes a Sequential, the
    # prediction conv after them
    i = 0
    while f'conv_{i}' in p:
        conv, bn = f'final_layer.{3 * i}.', f'final_layer.{3 * i + 1}.'
        sd[conv + 'weight'] = _t(np.transpose(p[f'conv_{i}']['kernel'],
                                              (3, 2, 0, 1)))
        sd[conv + 'bias'] = _t(p[f'conv_{i}']['bias'])
        sd[bn + 'weight'] = _t(p[f'conv_bn_{i}']['scale'])
        sd[bn + 'bias'] = _t(p[f'conv_bn_{i}']['bias'])
        if f'conv_bn_{i}' in stats:
            sd[bn + 'running_mean'] = _t(stats[f'conv_bn_{i}']['mean'])
            sd[bn + 'running_var'] = _t(stats[f'conv_bn_{i}']['var'])
            sd[bn + 'num_batches_tracked'] = torch.tensor(0)
        i += 1
    final = f'final_layer.{3 * i}.' if i else 'final_layer.'
    if 'final' in p:
        sd[final + 'weight'] = _t(np.transpose(p['final']['kernel'],
                                               (3, 2, 0, 1)))
        sd[final + 'bias'] = _t(p['final']['bias'])
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


# flax module name -> mmpose module name, one path component at a time
# (the inverse of the JAX converters' name maps)
_CNN_MODULES = [
    (r'layer(\d+)_(\d+)', r'layer\1.\2'),
    (r'stage(\d+)_mod(\d+)', r'stage\1.\2'),
    (r'branch(\d+)_block(\d+)', r'branches.\1.\2'),
    (r'fuse(\d+)_(\d+)_conv', r'fuse_layers.\1.\2.0'),
    (r'fuse(\d+)_(\d+)_bn', r'fuse_layers.\1.\2.1'),
    (r'fuse(\d+)_(\d+)_down(\d+)_conv', r'fuse_layers.\1.\2.\3.0'),
    (r'fuse(\d+)_(\d+)_down(\d+)_bn', r'fuse_layers.\1.\2.\3.1'),
    (r'tr(\d+)_conv', r'transition\1.\1.0.0'),
    (r'tr(\d+)_bn', r'transition\1.\1.0.1'),
    (r'ds_conv', 'downsample.0'),
    (r'ds', 'downsample.0'),
    (r'ds_bn', 'downsample.1'),
]
# the families whose JAX converter renames more, per module name
_SE_MODULES = [(r'se', 'se_layer'), (r'fc(\d)', r'conv\1.conv')]
_FAMILY_MODULES = {
    'resnext': _SE_MODULES, 'seresnet': _SE_MODULES,
    'seresnext': _SE_MODULES,
    'scnet': [(r'a1', 'conv1'), (r'a1_bn', 'bn1'), (r'a2', 'k1.0'),
              (r'a2_bn', 'k1.1'), (r'b1', 'conv2'), (r'b1_bn', 'bn2'),
              (r'out', 'conv3'), (r'out_bn', 'bn3'), (r'k2', 'k2.1'),
              (r'k2_bn', 'k2.2'), (r'k([34])', r'k\1.0'),
              (r'k([34])_bn', r'k\1.1')],
    'vipnas_resnet': [(r'add_fc1', 'channel_add_conv.0'),
                      (r'add_ln', 'channel_add_conv.1'),
                      (r'add_fc2', 'channel_add_conv.3')],
    'vipnas_mbv3': [(r'stem', 'conv1.conv'), (r'stem_bn', 'conv1.bn'),
                    (r'fc(\d)', r'conv\1.conv')],
}
# ViPNAS-MobileNetV3's block modules (s{i}b{j}_*, layer{n} in mmpose)
_MBV3_BLOCK = re.compile(r's(\d+)b(\d+)_(expand|dw|proj|se)(_bn)?')
_MBV3_PARTS = {'expand': 'expand_conv', 'dw': 'depthwise_conv',
               'proj': 'linear_conv'}
_LEAVES = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
           'mean': 'running_mean', 'var': 'running_var'}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _cnn_module_name(path, backbone_type, layer_of=None):
    """The mmpose module name of a flax module path of a CNN backbone
    (`layer_of`: ViPNAS-MobileNetV3's {(stage, block): n})."""
    out = []
    for part in path:
        m = _MBV3_BLOCK.fullmatch(part)
        if m and backbone_type == 'vipnas_mbv3':
            n = layer_of[int(m.group(1)), int(m.group(2))]
            out.append(f'layer{n}.se' if m.group(3) == 'se' else
                       f'layer{n}.{_MBV3_PARTS[m.group(3)]}.'
                       + ('bn' if m.group(4) else 'conv'))
            continue
        renamed = next((re.sub(pattern, repl, part) for pattern, repl
                        in _FAMILY_MODULES.get(backbone_type, ())
                        if re.fullmatch(pattern, part)), None)
        if renamed:
            out.append(renamed)
            continue
        m = re.fullmatch(r'stem_(conv|bn)(\d)', part)
        if m and backbone_type.startswith('hrnet'):
            out.append(f'{m.group(1)}{m.group(2)}')       # conv1, bn2, ...
            continue
        if m:                             # the ResNetV1d deep stem
            out.append(f'stem.{int(m.group(2)) - 1}.{m.group(1)}')
            continue
        m = re.fullmatch(r'tr1_(conv|bn)(\d)', part)
        if m:
            # transition1.0 = Sequential(conv, bn, ReLU), transition1.1 =
            # Sequential(Sequential(conv, bn, ReLU))
            idx = '0' if m.group(1) == 'conv' else '1'
            out.append(f'transition1.{m.group(2)}.'
                       + ('0.' if m.group(2) == '1' else '') + idx)
            continue
        for pattern, repl in _CNN_MODULES:
            if re.fullmatch(pattern, part):
                out.append(re.sub(pattern, repl, part))
                break
        else:
            out.append(part)                 # conv1, bn3, ...
    name = '.'.join(out)
    if backbone_type == 'resnet_v1d':
        # a strided avg_down shortcut is [AvgPool, conv, bn]
        # (vitpose_tpu/models/resnet.py:197-205)
        name = re.sub(r'^(layer[2-9]\d*\.\d+\.downsample)\.(\d)',
                      lambda m: f'{m.group(1)}.{int(m.group(2)) + 1}', name)
    return name


def cnn_state_dict_from_flax(variables, backbone_type) -> dict:
    """flax GenericTopDown variables of a `backbone_type` CNN (one of
    CNN_BACKBONES) with the classic or the ViPNAS head -> {port name: f32
    CPU tensor}, BN statistics included where the variables hold them."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    sd = _cnn_backbone(params['backbone'], stats.get('backbone', {}),
                       backbone_type)
    sd.update({f'keypoint_head.{k}': v for k, v in
               _head(params.get('head', {}), stats.get('head', {})).items()})
    return sd


def _cnn_backbone(params, stats, backbone_type):
    """A CNN backbone's flax params and batch_stats trees -> its entries
    under 'backbone.' and the mmpose names."""
    if backbone_type not in CNN_BACKBONES:
        raise KeyError(f'backbone_type {backbone_type!r}: the port converts '
                       f'{CNN_BACKBONES}')
    layer_of = None
    if backbone_type == 'vipnas_mbv3':
        blocks = {(int(m.group(1)), int(m.group(2))) for m in
                  map(_MBV3_BLOCK.fullmatch, params) if m}
        layer_of = {ij: n + 1 for n, ij in enumerate(sorted(blocks))}
    sd = {}
    for tree in (params, stats):
        for path, v in _flat(tree):
            module = _cnn_module_name(path[:-1], backbone_type, layer_of)
            v = np.asarray(v)
            if v.ndim == 2:
                # a Dense kernel [in, out]: nn.Linear's [out, in], or under
                # mmpose's names a 1x1 conv's [out, in, 1, 1] (_leaf turns
                # [1, 1, in, out] to it)
                v = v.T if backbone_type in FLAX_NAMED_BACKBONES \
                    else v[None, None]
            elif module.endswith('channel_add_conv.1'):
                v = v.reshape(-1, 1, 1)        # LayerNorm([planes, 1, 1])
            sd.update(_leaf(f'backbone.{module}.{_LEAVES[path[-1]]}',
                            path[-1], v))
    return sd


def _leaf(name, leaf, v):
    """{name: tensor} of one flax leaf, a 4-D kernel [kh, kw, a, b] turned
    to torch's [b, a, kh, kw] (a conv's [out, in, ...], a transposed conv's
    [in, out, ...]), with BN's num_batches_tracked beside a running mean."""
    v = np.asarray(v)
    out = {name: _t(np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v)}
    if leaf == 'mean':
        out[name.replace('running_mean', 'num_batches_tracked')] = \
            torch.tensor(0)
    return out


# AEHigherResolutionHead: flax module name -> mmpose module name (the
# inverse of vitpose_tpu/utils/cnn_ckpt.py:480-504 `convert_ae_higher_head`)
_AE_HIGHER_MODULES = [
    (r'final_(\d+)', r'final_layers.\1'),
    (r'deconv_(\d+)', r'deconv_layers.\1.0.0'),
    (r'deconv_(\d+)_bn', r'deconv_layers.\1.0.1'),
]


def _ae_higher_head(params, stats):
    sd = {}
    for tree in (params, stats):
        for path, v in _flat(tree):
            module, rest = path[0], '.'.join(path[1:-1])
            m = re.fullmatch(r'deconv_(\d+)_blk(\d+)', module)
            if m:
                name = (f'deconv_layers.{m.group(1)}.{int(m.group(2)) + 1}.0.'
                        f'{rest}')
            else:
                for pattern, repl in _AE_HIGHER_MODULES:
                    if re.fullmatch(pattern, module):
                        name = re.sub(pattern, repl, module)
                        break
                else:
                    raise KeyError(f'unknown AEHigherResolutionHead module '
                                   f'{module!r}')
            sd.update(_leaf(f'keypoint_head.{name}.{_LEAVES[path[-1]]}',
                            path[-1], v))
    return sd


def bottomup_state_dict_from_flax(variables, backbone_type) -> dict:
    """flax BottomUpEstimator variables ({'backbone': {'params',
    'batch_stats'}, 'head': {...}}, as JAX's `init` and its bottom-up
    runner's .npz hold them) -> {mmpose name: f32 CPU tensor}: the backbone
    through the ViT (`backbone_type` 'vit') or the CNN naming, the head as
    AEHead (flax `deconv_head`, the classic head's names) or
    AEHigherResolutionHead."""
    bb, head = variables['backbone'], variables['head']
    if backbone_type == 'vit':
        sd = {f'backbone.{k}': v
              for k, v in _backbone(bb['params']).items()}
    else:
        sd = _cnn_backbone(bb.get('params', {}), bb.get('batch_stats', {}),
                           backbone_type)
    hp, hs = head.get('params', {}), head.get('batch_stats', {})
    if 'deconv_head' in hp:
        sd.update({f'keypoint_head.{k}': v for k, v in
                   _head(hp['deconv_head'], hs.get('deconv_head', {}))
                   .items()})
    else:
        sd.update(_ae_higher_head(hp, hs))
    return sd
