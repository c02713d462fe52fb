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
stacked along `in`), for GenericTopDown's mmpose names; and, for the
multi-stage and lightweight backbones (MULTI_STAGE_BACKBONES), of
`convert_mspn` :241 (also RSN's), `convert_litehrnet` :401,
`convert_hourglass` :524, `convert_hourglass_ae` :560,
`convert_mobilenet_v2` :603, `convert_shufflenet_v2` :627, `convert_cpm`
:655, `convert_multistage_head` :719 and `convert_msmu_head` :755 (its
num_units read off the flax tree), and of `convert_hrformer` :338, each
run backwards by `_Writer`: the
same pairs of an mmpose entry and a flax module path, the flax tree
deciding what exists. The JAX package
has no converter for the FLAX_NAMED_BACKBONES: the port names their
modules after the flax paths (`_CNN_MODULES`), one entry per flax leaf,
Dense kernels as nn.Linear weights.
`bottomup_state_dict_from_flax` does the same for JAX's BottomUpEstimator
variables: the ViT or CNN backbone and the AE heads (the inverse of
vitpose_tpu/utils/family_ckpt.py:102 `convert_bottomup_checkpoint`, with
`_convert_ae_multi_head` :78).
`posewarper_state_dict_from_flax` and `pose_lifter_state_dict_from_flax`
run JAX's family converters backwards (vitpose_tpu/utils/family_ckpt.py:
125-155, 191-242, with `convert_tcn`, cnn_ckpt.py:578) for PoseWarper and
the pose lifters.
`hybrid_embed_state_dict_from_flax` carries JAX's `HybridEmbed` over:
its CNN trunk by the trunk's converter, and `proj`.
The flat 'a/b/c' .npz files that the JAX package's `save_params_npz`
writes are read by `utils.checkpoint.load_params_npz`.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# the backbones whose modules take the flax names, for want of a JAX
# converter from mmpose's: a reference mmpose .pth of them does not load
FLAX_NAMED_BACKBONES = ('resnest', 'vgg', 'alexnet', 'shufflenet_v1',
                        'regnet', 'mobilenet_v3')
# the backbones that `_Writer` converts, by JAX's converters run backwards
MULTI_STAGE_BACKBONES = ('mspn', 'rsn', 'litehrnet', 'hourglass',
                         'hourglass_ae', 'mobilenet_v2', 'shufflenet_v2',
                         'cpm', 'hrformer')
CNN_BACKBONES = ('resnet', 'resnet_v1d', 'hrnet', 'hrnetv2', 'resnext',
                 'seresnet', 'seresnext', 'scnet', 'vipnas_resnet',
                 'vipnas_mbv3') + FLAX_NAMED_BACKBONES + MULTI_STAGE_BACKBONES


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
    is the identity), SimpleHead (the prediction conv alone) or DeepPose's
    RegressionHead (`fc`). BN running statistics are carried where `stats`
    has them."""
    sd = {}
    if 'fc' in p:
        sd['fc.weight'] = _t(np.asarray(p['fc']['kernel']).T)
        sd['fc.bias'] = _t(p['fc']['bias'])
        return sd
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
    """flax GenericTopDown or GenericMultiStageTopDown variables of a
    `backbone_type` CNN (one of CNN_BACKBONES) with its head -> {port name:
    f32 CPU tensor}, BN statistics included where the variables hold
    them."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    sd = _cnn_backbone(params['backbone'], stats.get('backbone', {}),
                       backbone_type)
    head, head_stats = params.get('head', {}), stats.get('head', {})
    if backbone_type in _MULTI_STAGE_HEADS:
        w = _Writer(head, head_stats, 'keypoint_head.')
        _MULTI_STAGE_HEADS[backbone_type](w)
        sd.update(w.sd)
    else:
        sd.update({f'keypoint_head.{k}': v
                   for k, v in _head(head, head_stats).items()})
    return sd


def hybrid_embed_state_dict_from_flax(variables, backbone_type) -> dict:
    """flax HybridEmbed variables (JAX vitpose_tpu/models/vit.py:386) over a
    `backbone_type` CNN trunk -> the state dict of the port's
    `models.vit.HybridEmbed`: the trunk's entries under 'backbone.' by
    `cnn_state_dict_from_flax`'s converter, and the Dense `proj`."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    sd = _cnn_backbone(params['backbone'], stats.get('backbone', {}),
                       backbone_type)
    sd['proj.weight'] = _t(np.asarray(params['proj']['kernel']).T)
    sd['proj.bias'] = _t(params['proj']['bias'])
    return sd


def _cnn_backbone(params, stats, backbone_type):
    """A CNN backbone's flax params and batch_stats trees -> its entries
    under 'backbone.' and the mmpose names."""
    if backbone_type not in CNN_BACKBONES:
        raise KeyError(f'backbone_type {backbone_type!r}: the port converts '
                       f'{CNN_BACKBONES}')
    if backbone_type in MULTI_STAGE_BACKBONES:
        w = _Writer(params, stats, 'backbone.')
        _WRITERS[backbone_type](w)
        return w.sd
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
    AEMultiStageHead, AEHead (flax `deconv_head`, the classic head's names)
    or AEHigherResolutionHead."""
    # a parameterless head (Hourglass-AE's in the zoo) leaves no 'head' in
    # an .npz
    bb, head = variables['backbone'], variables.get('head', {})
    if backbone_type == 'vit':
        sd = {f'backbone.{k}': v
              for k, v in _backbone(bb['params']).items()}
    else:
        sd = _cnn_backbone(bb.get('params', {}), bb.get('batch_stats', {}),
                           backbone_type)
    hp, hs = head.get('params', {}), head.get('batch_stats', {})
    if all(re.fullmatch(r's\d+_(deconv_\d+|bn_\d+|final)', k) for k in hp):
        # AEMultiStageHead: none at all in the zoo's config
        w = _Writer(hp, hs, 'keypoint_head.')
        _multistage_head(w, 's{s}_')
        sd.update(w.sd)
    elif 'deconv_head' in hp:
        sd.update({f'keypoint_head.{k}': v for k, v in
                   _head(hp['deconv_head'], hs.get('deconv_head', {}))
                   .items()})
    else:
        sd.update(_ae_higher_head(hp, hs))
    return sd


# --- the multi-stage and lightweight CNNs: JAX's converters run backwards ---

class _Writer:
    """Writes the port's state dict under `prefix` from flax params and
    batch_stats trees, one call per pair of an mmpose entry and a flax
    module path ('a/b/c') of a JAX converter (`Cv` in
    vitpose_tpu/utils/cnn_ckpt.py:17); a call whose flax module does not
    exist writes nothing and returns False."""

    def __init__(self, params, stats, prefix):
        self.params, self.stats, self.prefix = params, stats, prefix
        self.sd = {}

    @staticmethod
    def _node(tree, fpath):
        for part in fpath.split('/'):
            if not isinstance(tree, dict) or part not in tree:
                return None
            tree = tree[part]
        return tree

    def has(self, fpath):
        return self._node(self.params, fpath) is not None

    def conv(self, tname, fpath):
        """A conv (or transposed conv) kernel and its bias, if any."""
        p = self._node(self.params, fpath)
        if p is None:
            return False
        self.sd.update(_leaf(f'{self.prefix}{tname}.weight', 'kernel',
                             p['kernel']))
        if 'bias' in p:
            self.sd[f'{self.prefix}{tname}.bias'] = _t(p['bias'])
        return True

    def linear(self, tname, fpath, conv=False):
        """A Dense layer as nn.Linear's [out, in], or with `conv` as a 1x1
        conv's [out, in, 1, 1] (JAX's `Cv.linear` reads either)."""
        p = self._node(self.params, fpath)
        if p is None:
            return False
        w = np.asarray(p['kernel']).T
        self.sd[f'{self.prefix}{tname}.weight'] = _t(
            w[:, :, None, None] if conv else w)
        if 'bias' in p:
            self.sd[f'{self.prefix}{tname}.bias'] = _t(p['bias'])
        return True

    def ln(self, tname, fpath):
        """A LayerNorm's weight and bias <- flax's scale and bias."""
        p = self._node(self.params, fpath)
        if p is None:
            return False
        self.sd[f'{self.prefix}{tname}.weight'] = _t(p['scale'])
        self.sd[f'{self.prefix}{tname}.bias'] = _t(p['bias'])
        return True

    def raw(self, tname, fpath):
        """A parameter copied as it is from the flax leaf `fpath`."""
        v = self._node(self.params, fpath)
        if v is None:
            return False
        self.sd[f'{self.prefix}{tname}'] = _t(v)
        return True

    def bn(self, tname, fpath):
        p = self._node(self.params, fpath)
        if p is None:
            return False
        name = f'{self.prefix}{tname}.'
        self.sd[name + 'weight'] = _t(p['scale'])
        self.sd[name + 'bias'] = _t(p['bias'])
        s = self._node(self.stats, fpath)
        if s is not None:
            self.sd.update(_leaf(name + 'running_mean', 'mean', s['mean']))
            self.sd[name + 'running_var'] = _t(s['var'])
        return True

    def conv_module(self, tname, fpath):
        """mmcv's ConvModule: `{t}.conv` + `{t}.bn` <- `{f}_conv`,
        `{f}_bn`."""
        ok = self.conv(f'{tname}.conv', f'{fpath}_conv')
        self.bn(f'{tname}.bn', f'{fpath}_bn')
        return ok

    def resnet_block(self, tname, fpath):
        """A BasicBlock or Bottleneck: conv1..3, bn1..3 and `downsample.0`,
        `.1` <- ds_conv, ds_bn (cnn_ckpt.py:111 `_resnet_block`)."""
        for i in (1, 2, 3):
            self.conv(f'{tname}.conv{i}', f'{fpath}/conv{i}')
            self.bn(f'{tname}.bn{i}', f'{fpath}/bn{i}')
        self.conv(f'{tname}.downsample.0', f'{fpath}/ds_conv')
        self.bn(f'{tname}.downsample.1', f'{fpath}/ds_bn')

    def res_layer(self, tname, fpath):
        k = 0
        while self.has(f'{fpath}_{k}'):
            self.resnet_block(f'{tname}.{k}', f'{fpath}_{k}')
            k += 1


def _mspn(w, stage_key):
    """convert_mspn (cnn_ckpt.py:241) backwards; `stage_key`
    'multi_stage_mspn' or 'multi_stage_rsn'."""
    w.conv_module('top.top.0', 'top')
    st = 0
    while w.has(f'stage{st}'):
        t0, f0 = f'{stage_key}.{st}', f'stage{st}'
        u = 1
        while w.has(f'{f0}/downsample/layer{u}_0'):
            b = 0
            while w.has(f'{f0}/downsample/layer{u}_{b}'):
                t = f'{t0}.downsample.layer{u}.{b}'
                f = f'{f0}/downsample/layer{u}_{b}'
                if w.has(f'{f}/conv1'):                 # MSPN's bottleneck
                    for i in (1, 2, 3):
                        w.conv(f'{t}.conv{i}', f'{f}/conv{i}')
                        w.bn(f'{t}.bn{i}', f'{f}/bn{i}')
                    w.conv(f'{t}.downsample.conv', f'{f}/ds_conv')
                    w.bn(f'{t}.downsample.bn', f'{f}/ds_bn')
                else:                                   # RSN's RSB
                    w.conv_module(f'{t}.conv_bn_relu1', f'{f}/conv_bn_relu1')
                    i = 1
                    while w.has(f'{f}/conv_bn_relu2_{i}_1_conv'):
                        for j in range(1, i + 1):
                            w.conv_module(f'{t}.conv_bn_relu2_{i}_{j}',
                                          f'{f}/conv_bn_relu2_{i}_{j}')
                        i += 1
                    w.conv_module(f'{t}.conv_bn3', f'{f}/conv_bn3')
                    w.conv_module(f'{t}.downsample', f'{f}/downsample')
                b += 1
            u += 1
        u = 1
        while w.has(f'{f0}/up{u}/in_skip_conv'):
            for part in ('in_skip', 'up_conv', 'out_skip1', 'out_skip2',
                         'cross_conv'):
                w.conv_module(f'{t0}.upsample.up{u}.{part}',
                              f'{f0}/up{u}/{part}')
            u += 1
        st += 1


def _litehrnet(w):
    """convert_litehrnet (cnn_ckpt.py:401) backwards."""
    w.conv('stem.conv1.conv', 'stem/conv1')
    w.bn('stem.conv1.bn', 'stem/conv1_bn')
    w.conv('stem.branch1.0.conv', 'stem/b1_dw')
    w.bn('stem.branch1.0.bn', 'stem/b1_dw_bn')
    w.conv('stem.branch1.1.conv', 'stem/b1_pw')
    w.bn('stem.branch1.1.bn', 'stem/b1_pw_bn')
    for t, f in (('expand_conv', 'expand'), ('depthwise_conv', 'dw'),
                 ('linear_conv', 'linear')):
        w.conv(f'stem.{t}.conv', f'stem/{f}')
        w.bn(f'stem.{t}.bn', f'stem/{f}_bn')
    si = 0
    while w.has(f'stage{si}_m0_fuse') or w.has(f'stage{si}_m0_blk0'):
        for b in range(8):
            t = f'transition{si}.{b}'
            if w.conv(f'{t}.0', f'tr{si}_{b}_dw'):      # an existing branch
                w.bn(f'{t}.1', f'tr{si}_{b}_dwbn')
                w.conv(f'{t}.2', f'tr{si}_{b}_pw')
                w.bn(f'{t}.3', f'tr{si}_{b}_pwbn')
            k = 0
            while w.conv(f'{t}.{k}.0', f'tr{si}_{b}_c{k}_dw'):   # new ones
                w.bn(f'{t}.{k}.1', f'tr{si}_{b}_c{k}_dwbn')
                w.conv(f'{t}.{k}.2', f'tr{si}_{b}_c{k}_pw')
                w.bn(f'{t}.{k}.3', f'tr{si}_{b}_c{k}_pwbn')
                k += 1
        m = 0
        while w.has(f'stage{si}_m{m}_blk0') or w.has(f'stage{si}_m{m}_fuse'):
            k = 0
            while w.has(f'stage{si}_m{m}_blk{k}'):
                t, f = f'stage{si}.{m}.layers.{k}', f'stage{si}_m{m}_blk{k}'
                crw = f'{t}.cross_resolution_weighting'
                for c in ('conv1', 'conv2'):
                    w.conv(f'{crw}.{c}.conv', f'{f}/crw/{c}')
                    w.bn(f'{crw}.{c}.bn', f'{f}/crw/{c}_bn')
                b = 0
                while w.conv(f'{t}.depthwise_convs.{b}.conv', f'{f}/dw{b}'):
                    w.bn(f'{t}.depthwise_convs.{b}.bn', f'{f}/dw{b}_bn')
                    for c in ('conv1', 'conv2'):
                        w.linear(f'{t}.spatial_weighting.{b}.{c}.conv',
                                 f'{f}/sw{b}/fc{c[-1]}', conv=True)
                    b += 1
                k += 1
            f0 = f'stage{si}_m{m}_fuse'
            for i in range(8):
                for j in range(8):
                    tf = f'stage{si}.{m}.fuse_layers.{i}.{j}'
                    if j > i:
                        w.conv(f'{tf}.0', f'{f0}/fuse{i}_{j}_conv')
                        w.bn(f'{tf}.1', f'{f0}/fuse{i}_{j}_bn')
                    elif j < i:
                        for d in range(i - j):
                            w.conv(f'{tf}.{d}.0', f'{f0}/fuse{i}_{j}_d{d}_dw')
                            w.bn(f'{tf}.{d}.1', f'{f0}/fuse{i}_{j}_d{d}_dwbn')
                            w.conv(f'{tf}.{d}.2', f'{f0}/fuse{i}_{j}_d{d}_pw')
                            w.bn(f'{tf}.{d}.3', f'{f0}/fuse{i}_{j}_d{d}_pwbn')
            m += 1
        si += 1


def _hourglass_module(w, tname, fname):
    w.res_layer(f'{tname}.up1', f'{fname}/up1')
    w.res_layer(f'{tname}.low1', f'{fname}/low1')
    if w.has(f'{fname}/low2/up1_0'):
        _hourglass_module(w, f'{tname}.low2', f'{fname}/low2')
    else:
        w.res_layer(f'{tname}.low2', f'{fname}/low2')
    w.res_layer(f'{tname}.low3', f'{fname}/low3')


def _hourglass(w):
    """convert_hourglass (cnn_ckpt.py:524) backwards."""
    w.conv_module('stem.0', 'stem')
    w.res_layer('stem.1', 'stem_res')
    i = 0
    while w.has(f'hg{i}'):
        _hourglass_module(w, f'hourglass_modules.{i}', f'hg{i}')
        w.conv_module(f'out_convs.{i}', f'out_conv{i}')
        w.conv_module(f'conv1x1s.{i}', f'conv1x1_{i}')
        w.conv_module(f'remap_convs.{i}', f'remap{i}')
        if w.has(f'inters_{i}_0'):
            w.resnet_block(f'inters.{i}', f'inters_{i}_0')
        i += 1


def _hourglass_ae_module(w, tname, fname):
    for part in ('up1', 'low1'):
        w.conv_module(f'{tname}.{part}', f'{fname}/{part}')
    if w.has(f'{fname}/low2/up1_conv'):
        _hourglass_ae_module(w, f'{tname}.low2', f'{fname}/low2')
    else:
        w.conv_module(f'{tname}.low2', f'{fname}/low2')
    w.conv_module(f'{tname}.low3', f'{fname}/low3')


def _hourglass_ae(w):
    """convert_hourglass_ae (cnn_ckpt.py:560) backwards."""
    for i, t in enumerate((0, 1, 3, 4)):         # stem.2 is the max pool
        w.conv_module(f'stem.{t}', f'stem{i}')
    i = 0
    while w.has(f'hg{i}'):
        _hourglass_ae_module(w, f'hourglass_modules.{i}.0', f'hg{i}')
        w.conv_module(f'hourglass_modules.{i}.1', f'hgc{i}_0')
        w.conv_module(f'hourglass_modules.{i}.2', f'hgc{i}_1')
        w.conv(f'out_convs.{i}.conv', f'out_conv{i}_conv')
        w.conv_module(f'remap_out_convs.{i}', f'remap_out{i}')
        w.conv_module(f'remap_feature_convs.{i}', f'remap_feat{i}')
        i += 1


def _mobilenet_v2(w):
    """convert_mobilenet_v2 (cnn_ckpt.py:603) backwards."""
    w.conv('conv1.conv', 'stem')
    w.bn('conv1.bn', 'stem_bn')
    for li in range(1, 8):
        bi = 0
        while w.has(f'layer{li - 1}_{bi}'):
            f = f'layer{li - 1}_{bi}'
            names = (['expand', 'dw', 'project'] if w.has(f'{f}/expand')
                     else ['dw', 'project'])
            for k, nm in enumerate(names):
                w.conv(f'layer{li}.{bi}.conv.{k}.conv', f'{f}/{nm}')
                w.bn(f'layer{li}.{bi}.conv.{k}.bn', f'{f}/{nm}_bn')
            bi += 1
    w.conv('conv2.conv', 'head_conv')
    w.bn('conv2.bn', 'head_bn')


def _shufflenet_v2(w):
    """convert_shufflenet_v2 (cnn_ckpt.py:627) backwards."""
    w.conv('conv1.conv', 'stem')
    w.bn('conv1.bn', 'stem_bn')
    for s in range(3):
        b = 0
        while w.has(f'stage{s}_{b}'):
            t, f = f'layers.{s}.{b}', f'stage{s}_{b}'
            for tn, fconv, fbn in (('branch1.0', 'proj_dw', 'proj_dwbn'),
                                   ('branch1.1', 'proj_pw', 'proj_bn'),
                                   ('branch2.0', 'main_pw1', 'main_bn1'),
                                   ('branch2.1', 'main_dw', 'main_dwbn'),
                                   ('branch2.2', 'main_pw2', 'main_bn2')):
                w.conv(f'{t}.{tn}.conv', f'{f}/{fconv}')
                w.bn(f'{t}.{tn}.bn', f'{f}/{fbn}')
            b += 1
    w.conv('layers.3.conv', 'head_conv')
    w.bn('layers.3.bn', 'head_bn')


def _cpm(w):
    """convert_cpm (cnn_ckpt.py:655) backwards."""
    for ti, f in ((0, 'stem0'), (2, 'stem1'), (4, 'stem2'), (6, 'stem3'),
                  (7, 'stem4'), (8, 'stem5')):
        w.conv_module(f'stem.{ti}', f)
    w.conv('stem.9.conv', 'stem6_conv')
    for ti, f in ((0, 'mid0'), (2, 'mid1'), (4, 'mid2')):
        w.conv_module(f'middle.{ti}', f)
    t = 0
    while w.has(f'stage{t}_b0_conv'):
        w.conv_module(f'middle_conv.{t}.0', f'midconv{t}')
        for i in range(3):
            w.conv_module(f'cpm_stages.{t}.model.{i}', f'stage{t}_b{i}')
        w.conv_module(f'out_convs.{t}.0', f'stage{t}_fc')
        w.conv(f'out_convs.{t}.1.conv', f'stage{t}_out_conv')
        t += 1


def _multistage_head(w, stage='stage_{s}/'):
    """convert_multistage_head (cnn_ckpt.py:719) backwards, or with
    `stage` 's{s}_' `_convert_ae_multi_head` (family_ckpt.py:78)."""
    s = 0
    while any(k.startswith(stage.format(s=s).rstrip('/')) for k in w.params):
        p = stage.format(s=s)
        d = 0
        while w.conv(f'multi_deconv_layers.{s}.{3 * d}', f'{p}deconv_{d}'):
            w.bn(f'multi_deconv_layers.{s}.{3 * d + 1}', f'{p}bn_{d}')
            d += 1
        w.conv(f'multi_final_layers.{s}', f'{p}final')
        s += 1


def _msmu_head(w):
    """convert_msmu_head (cnn_ckpt.py:755) backwards: entry
    predict_layers.{s * num_units + u} of flax's `s{s}_u{u}_*`."""
    units = 1 + max(int(re.match(r's0_u(\d+)_', k).group(1))
                    for k in w.params if k.startswith('s0_u'))
    s = 0
    while w.has(f's{s}_u0_conv1'):
        for u in range(units):
            nm, t = f's{s}_u{u}', f'predict_layers.{s * units + u}'
            for ci in (1, 2):
                w.conv(f'{t}.conv_layers.{ci - 1}.conv', f'{nm}_conv{ci}')
                w.bn(f'{t}.conv_layers.{ci - 1}.bn', f'{nm}_bn{ci}')
            prm, pn = f'{t}.prm', f'{nm}_prm'
            if not w.has(pn):
                continue
            w.conv(f'{prm}.conv_bn_relu_prm_1.conv', f'{pn}/prm1_conv')
            w.bn(f'{prm}.conv_bn_relu_prm_1.bn', f'{pn}/prm1_bn')
            for i, (fc, bn) in enumerate((('mid_fc1', 'mid_bn1'),
                                          ('mid_fc2', 'mid_bn2'))):
                w.linear(f'{prm}.middle_path.{3 * i}', f'{pn}/{fc}')
                w.bn(f'{prm}.middle_path.{3 * i + 1}', f'{pn}/{bn}')
            for tn, f in (('bottom_path.0', 'bot'),
                          ('bottom_path.1.depthwise_conv', 'bot_dw'),
                          ('bottom_path.1.pointwise_conv', 'bot_pw')):
                w.conv(f'{prm}.{tn}.conv', f'{pn}/{f}_conv')
                w.bn(f'{prm}.{tn}.bn', f'{pn}/{f}_bn')
        s += 1


def _hrformer(w):
    """convert_hrformer (cnn_ckpt.py:338) backwards."""
    for i in (1, 2):
        w.conv(f'conv{i}', f'stem{i}')
        w.bn(f'bn{i}', f'stem{i}_bn')
    w.res_layer('layer1', 'layer1')
    w.conv('transition1.0.0', 'tr1_conv0')
    w.bn('transition1.0.1', 'tr1_bn0')
    w.conv('transition1.1.0.0', 'tr1_conv1')
    w.bn('transition1.1.0.1', 'tr1_bn1')
    for s in (2, 3, 4):
        st, m = s - 2, 0
        while w.has(f's{st}_m{m}_b0_t0'):
            for b in range(4):
                t = 0
                while w.has(f's{st}_m{m}_b{b}_t{t}'):
                    tb = f'stage{s}.{m}.branches.{b}.{t}'
                    fb = f's{st}_m{m}_b{b}_t{t}'
                    w.ln(f'{tb}.norm1', f'{fb}/norm1')
                    w.ln(f'{tb}.norm2', f'{fb}/norm2')
                    w.linear(f'{tb}.attn.attn.qkv', f'{fb}/attn/qkv')
                    w.linear(f'{tb}.attn.attn.proj', f'{fb}/attn/proj')
                    w.raw(f'{tb}.attn.attn.relative_position_bias_table',
                          f'{fb}/attn/rel_pos_bias_table')
                    for tn, fn in (('fc1', 'ffn_fc1'), ('norm1', 'ffn_bn1'),
                                   ('dw3x3', 'ffn_dw'), ('norm2', 'ffn_bn2'),
                                   ('fc2', 'ffn_fc2'), ('norm3', 'ffn_bn3')):
                        (w.bn if tn.startswith('norm') else w.conv)(
                            f'{tb}.ffn.{tn}', f'{fb}/{fn}')
                    t += 1
            f0 = f's{st}_m{m}_fuse'
            for i in range(4):
                for j in range(4):
                    tf = f'stage{s}.{m}.fuse_layers.{i}.{j}'
                    if j > i:
                        w.conv(f'{tf}.0', f'{f0}/fuse{i}_{j}_conv')
                        w.bn(f'{tf}.1', f'{f0}/fuse{i}_{j}_bn')
                    for d in range(i - j):
                        fd = f'{f0}/fuse{i}_{j}_d{d}'
                        w.conv(f'{tf}.{d}.0', f'{fd}_dw')
                        w.bn(f'{tf}.{d}.1', f'{fd}_dwbn')
                        w.conv(f'{tf}.{d}.2', f'{fd}_pw')
                        w.bn(f'{tf}.{d}.3', f'{fd}_pwbn')
            m += 1
        if s < 4:
            w.conv(f'transition{s}.{s}.0.0', f'tr{s}')
            w.bn(f'transition{s}.{s}.0.1', f'tr{s}_bn')


_WRITERS = {
    'mspn': lambda w: _mspn(w, 'multi_stage_mspn'),
    'rsn': lambda w: _mspn(w, 'multi_stage_rsn'),
    'litehrnet': _litehrnet, 'hourglass': _hourglass,
    'hourglass_ae': _hourglass_ae, 'mobilenet_v2': _mobilenet_v2,
    'shufflenet_v2': _shufflenet_v2, 'cpm': _cpm, 'hrformer': _hrformer,
}
# the backbones whose top-down head is not the classic one (JAX's
# HEAD_CONVERTERS, cnn_ckpt.py:865): CPM's identity head has no entries
_MULTI_STAGE_HEADS = {'hourglass': _multistage_head, 'mspn': _msmu_head,
                      'rsn': _msmu_head, 'cpm': lambda w: None}


# --- the video and 3D families: JAX's family converters run backwards ---

def posewarper_state_dict_from_flax(variables, backbone_type='hrnet'):
    """flax PoseWarper variables ({'params': {'backbone', 'neck', 'head'},
    'batch_stats': ...}, as JAX's init and its loop's .npz hold them) ->
    {mmpose name: f32 CPU tensor}: the inverse of
    vitpose_tpu/utils/family_ckpt.py:191-242 (`_convert_posewarper_neck`,
    `convert_posewarper_checkpoint`): the CNN backbone, the neck's
    trans_layer, its BasicBlock chain `offset_feats.{i}`, the offset convs
    and the deformable kernels (flax [kh, kw, in, out] -> [out, in, kh,
    kw]), and the head where it has parameters (the stage-2 identity head
    has none)."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    sd = _cnn_backbone(params['backbone'], stats.get('backbone', {}),
                       backbone_type)
    w = _Writer(params['neck'], stats.get('neck', {}), 'neck.')
    w.conv('trans_layer', 'trans_layer')
    i = 0
    while w.has(f'offset_feats_{i}'):
        w.resnet_block(f'offset_feats.{i}', f'offset_feats_{i}')
        i += 1
    j = 0
    while w.conv(f'offset_layers.{j}', f'offset_layers_{j}'):
        j += 1
    j = 0
    while w.has(f'deform_conv_{j}'):
        w.sd.update(_leaf(f'neck.deform_conv_layers.{j}.weight', 'kernel',
                          w._node(w.params, f'deform_conv_{j}')))
        j += 1
    sd.update(w.sd)
    sd.update({f'keypoint_head.{k}': v for k, v in
               _head(params.get('head', {}), stats.get('head', {})).items()})
    return sd


def _tcn(w, prefix):
    """TCN (the inverse of vitpose_tpu/utils/cnn_ckpt.py:578 `convert_tcn`):
    flax Conv1D kernels [k, in, out] -> Conv1d [out, in, k]."""
    def conv1d(tname, fpath):
        p = w._node(w.params, fpath)
        if p is None:
            return False
        w.sd[f'{w.prefix}{prefix}{tname}.weight'] = _t(
            np.transpose(p['kernel'], (2, 1, 0)))
        return True

    def bn(tname, fpath):
        w.bn(f'{prefix}{tname}', fpath)

    conv1d('expand_conv.conv', 'stem_conv')
    bn('expand_conv.bn', 'stem_bn')
    i = 0
    while conv1d(f'tcn_blocks.{i}.conv1.0.conv', f'block{i}_conv1'):
        bn(f'tcn_blocks.{i}.conv1.0.bn', f'block{i}_bn1')
        conv1d(f'tcn_blocks.{i}.conv2.0.conv', f'block{i}_conv2')
        bn(f'tcn_blocks.{i}.conv2.0.bn', f'block{i}_bn2')
        i += 1


def pose_lifter_state_dict_from_flax(variables) -> dict:
    """flax PoseLifter variables -> the port's state dict: the inverse of
    `convert_pose_lifter_checkpoint` and `_lifter_head`
    (vitpose_tpu/utils/family_ckpt.py:125-155): `backbone` and, with the
    trajectory branch, `traj_backbone` TCNs; the heads' Dense 'fc' ->
    `keypoint_head.conv` / `traj_head.conv`, a 1x1 Conv1d [out, in, 1]."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    sd = {}
    for flax_bb, flax_head, bb, head in (
            ('backbone', 'head', 'backbone.', 'keypoint_head.'),
            ('traj_backbone', 'traj_head', 'traj_backbone.', 'traj_head.')):
        if flax_bb not in params:
            continue
        w = _Writer(params[flax_bb], stats.get(flax_bb, {}), bb)
        _tcn(w, '')
        sd.update(w.sd)
        fc = params[flax_head]['fc']
        sd[head + 'conv.weight'] = _t(np.asarray(fc['kernel']).T[:, :, None])
        sd[head + 'conv.bias'] = _t(fc['bias'])
    return sd


# --- the one-config families: JAX's family converters run backwards ---

def _family_backbone(variables, backbone_type):
    """The trunk of a family's {'backbone': {'params', 'batch_stats'}}
    variables under 'backbone.': the ViT's names or a CNN's."""
    bb = variables['backbone']
    if backbone_type == 'vit':
        return {f'backbone.{k}': v
                for k, v in _backbone(bb['params']).items()}
    return _cnn_backbone(bb.get('params', {}), bb.get('batch_stats', {}),
                         backbone_type)


def _dense(sd, name, p):
    sd[f'{name}.weight'] = _t(np.asarray(p['kernel']).T)
    sd[f'{name}.bias'] = _t(p['bias'])


def interhand3d_state_dict_from_flax(variables, backbone_type='resnet'):
    """flax Interhand3DEstimator variables ({'backbone', 'head'}, as JAX's
    init and its loop's .npz hold them) -> the port's state dict: the
    inverse of vitpose_tpu/utils/family_ckpt.py:158 (the `right_`/`left_`
    Heatmap3DHead stacks -> `keypoint_head.{right,left}_hand_head`, or
    JAX's fused stack `deconv_i`/`bn_i`/`hm3d` -> `keypoint_head.hand_head`;
    `root_fc1/2` -> `root_head.fc.0/2`, `type_fc1/2` ->
    `hand_type_head.fc.0/2`)."""
    sd = _family_backbone(variables, backbone_type)
    hp = variables['head']['params']
    hs = variables['head'].get('batch_stats', {})
    split = any(k.startswith('right_') for k in hp)
    for prefix, name in ((('right_', 'right_hand_head'),
                          ('left_', 'left_hand_head')) if split
                         else (('', 'hand_head'),)):
        sub = {k[len(prefix):]: v for k, v in hp.items()
               if k.startswith(prefix)}
        if not split:
            sub['final'] = hp['hm3d']
        stats = {k[len(prefix):]: v for k, v in hs.items()
                 if k.startswith(prefix)}
        sd.update({f'keypoint_head.{name}.{k}': v
                   for k, v in _head(sub, stats).items()})
    for flax_name, name in (('root_fc1', 'root_head.fc.0'),
                            ('root_fc2', 'root_head.fc.2'),
                            ('type_fc1', 'hand_type_head.fc.0'),
                            ('type_fc2', 'hand_type_head.fc.2')):
        _dense(sd, f'keypoint_head.{name}', hp[flax_name])
    return sd


def mesh_state_dict_from_flax(variables, backbone_type='resnet'):
    """flax ParametricMesh variables ({'backbone', 'head'}; JAX's loop's
    .npz holds {'gen': ..., 'disc': ...} and the generator is read) -> the
    port's state dict: the inverse of vitpose_tpu/utils/family_ckpt.py:243
    (`fc1`, `fc2`; the fused 'out' Dense split into `decpose`, `decshape`,
    `deccam`; `mean_params` into the `init_pose`, `init_shape`, `init_cam`
    buffers)."""
    if 'gen' in variables:
        variables = variables['gen']
    sd = _family_backbone(variables, backbone_type)
    hp = variables['head']['params']
    for fc in ('fc1', 'fc2'):
        _dense(sd, f'mesh_head.{fc}', hp[fc])
    npar = np.asarray(hp['out']['bias']).shape[0]
    bounds = {'decpose': (0, npar - 13), 'decshape': (npar - 13, npar - 3),
              'deccam': (npar - 3, npar)}
    for name, (a, b) in bounds.items():
        _dense(sd, f'mesh_head.{name}', {
            'kernel': np.asarray(hp['out']['kernel'])[:, a:b],
            'bias': np.asarray(hp['out']['bias'])[a:b]})
    mean = np.asarray(hp['mean_params'])
    for name, (a, b) in zip(('init_pose', 'init_shape', 'init_cam'),
                            bounds.values()):
        sd[f'mesh_head.{name}'] = _t(mean[a:b][None])
    return sd


def _v2v(w):
    """V2VNet (the inverse of vitpose_tpu/utils/family_ckpt.py:274
    `_convert_v2v`): flax Conv [kd, kh, kw, in, out] -> Conv3d [out, in,
    kd, kh, kw]; ConvTranspose [kd, kh, kw, out, in] -> ConvTranspose3d
    [in, out, kd, kh, kw]."""
    def conv3(tname, fpath):
        p = w._node(w.params, fpath)
        if p is None:
            return
        w.sd[f'{w.prefix}{tname}.weight'] = _t(
            np.transpose(p['kernel'], (4, 3, 0, 1, 2)))
        w.sd[f'{w.prefix}{tname}.bias'] = _t(p['bias'])

    def res3d(tname, fname):
        for i in (0, 1):
            conv3(f'{tname}.res_branch.{i}.conv', f'{fname}/conv{i + 1}')
            w.bn(f'{tname}.res_branch.{i}.bn', f'{fname}/bn{i + 1}')
        conv3(f'{tname}.skip_con.conv', f'{fname}/skip_conv')
        w.bn(f'{tname}.skip_con.bn', f'{fname}/skip_bn')

    conv3('front_layers.0.block.conv', 'front_basic/conv')
    w.bn('front_layers.0.block.bn', 'front_basic/bn')
    res3d('front_layers.1', 'front_res')
    for name in ('skip_res1', 'skip_res2', 'encoder_res1', 'encoder_res2',
                 'mid_res', 'decoder_res1', 'decoder_res2'):
        res3d(f'encoder_decoder.{name}', name)
    for name in ('decoder_upsample1', 'decoder_upsample2'):
        p = w._node(w.params, f'{name}/deconv')
        t = f'{w.prefix}encoder_decoder.{name}.block.0.'
        w.sd[t + 'weight'] = _t(np.transpose(p['kernel'], (4, 3, 0, 1, 2)))
        w.sd[t + 'bias'] = _t(p['bias'])
        w.bn(f'encoder_decoder.{name}.block.1', f'{name}/bn')
    conv3('output_layer', 'output_layer')


def voxelpose_state_dict_from_flax(variables):
    """flax DetectAndRegress variables ({'center', 'pose'}, each
    {'params': {'v2v'}, 'batch_stats': {'v2v'}}) -> the port's state dict
    (`human_detector.center_net.*`, `pose_regressor.pose_net.*`, mmpose's
    names): the inverse of vitpose_tpu/utils/family_ckpt.py:325."""
    sd = {}
    for flax_name, name in (('center', 'human_detector.center_net.'),
                            ('pose', 'pose_regressor.pose_net.')):
        v = variables[flax_name]
        w = _Writer(v['params']['v2v'], v.get('batch_stats', {}).get(
            'v2v', {}), name)
        _v2v(w)
        sd.update(w.sd)
    return sd
