"""HRFormer backbone in PyTorch, with mmpose's parameter names.

Counterpart of vitpose_tpu/models/hrformer.py: the HRNet stem and two
bottlenecks, then parallel branches of HRFormer blocks (LayerNorm, window
self-attention with a relative-position bias; LayerNorm, the CrossFFN of
1x1 -> BN -> GELU -> depthwise 3x3 -> BN -> GELU -> 1x1 -> BN -> GELU),
fused HRNet-style: a lower-resolution branch j > i gives branch i a 1x1
conv and BN, then a bilinear resize (align_corners=False, which is
jax.image.resize's 'bilinear' when it enlarges); a higher-resolution one
i - j stride-2 links of depthwise 3x3 -> BN -> pointwise 1x1 -> BN, with a
ReLU after every link but the last. The last module of the last stage fuses
branch 0 alone, and each transition adds a branch from the lowest one.

The window attention copies JAX's order: the features are padded with
zeros to multiples of the window, centred (ph // 2 before, the rest after),
the padded tokens attend and are attended to unmasked, and the merge crops
from ph // 2; q is scaled before its product with k, the logits, their
bias and the softmax are in f32 (f64 in a float64 model), the
probabilities are cast to the model dtype before their product with v.
The bias table is indexed by JAX's `_rel_position_index`, whose columns are
mirrored (mmpose's `flip(1)`). The products stay torch ops: the head
dimension (39 in HRFormer-B) and the bias rule out K1.

Names as in mmpose hrformer.py: `conv1`/`bn1`/`conv2`/`bn2`, `layer1.{k}`,
`transition1.{0,1}`, `stage{s}.{m}.branches.{b}.{t}` (`norm1`,
`attn.attn.{qkv,proj,relative_position_bias_table}`, `norm2`,
`ffn.{fc1,norm1,dw3x3,norm2,fc2,norm3}`), `stage{s}.{m}.fuse_layers.{i}.{j}`
and `transition{s}.{s}.0`. mmpose also stores the index as the buffer
`relative_position_index`; the port computes it from the window size
(copied once per device) and drops a stored one when a state dict loads.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .hrnet import _conv_bn, _conv_bn_seq
from .resnet import Bottleneck, conv2d, init_cnn, make_downsample, norm
from .vit import at_least_f32, compute_dtype, linear, normal_


def rel_position_index(wh, ww):
    """The relative-position lookup [Wh*Ww, Wh*Ww] with its columns
    mirrored (JAX's `_rel_position_index`, mmpose's double_step_seq and
    flip(1))."""
    seq1 = np.arange(wh) * (2 * ww - 1)
    seq2 = np.arange(ww)
    coords = (seq1[:, None] + seq2[None, :]).reshape(1, -1)
    idx = coords + coords.T
    return idx[:, ::-1].copy()


def window_partition(x, ws):
    """NHWC `x` -> ([N * windows, ws * ws, C], padded (h, w), pads): zeros
    padded to multiples of `ws`, ph // 2 rows before and the rest after
    (columns likewise)."""
    n, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    hp, wp = h + ph, w + pw
    x = x.reshape(n, hp // ws, ws, wp // ws, ws, c)
    return (x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c), (hp, wp),
            (ph, pw))


def window_merge(x, ws, padded_hw, orig_hw, pads, n):
    """The inverse of window_partition, cropped back to `orig_hw` from the
    centred pad."""
    (hp, wp), (h, w), (ph, pw) = padded_hw, orig_hw, pads
    x = x.reshape(n, hp // ws, wp // ws, ws, ws, x.shape[-1])
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, hp, wp, -1)
    return x[:, ph // 2:h + ph // 2, pw // 2:w + pw // 2]


class WindowMSA(nn.Module):
    """Multi-head self-attention inside each window, with the
    relative-position bias (mmpose's WindowMSA: `qkv`, `proj`,
    `relative_position_bias_table`)."""

    def __init__(self, dim, num_heads, window_size):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self._index = {}                      # device -> the flat index
        self._register_load_state_dict_pre_hook(self._drop_stored_index)

    @staticmethod
    def _drop_stored_index(state_dict, prefix, *args):
        state_dict.pop(prefix + 'relative_position_index', None)

    def position_index(self, device):
        """The flat lookup index on `device`, copied there once."""
        if device not in self._index:
            ws = self.window_size
            self._index[device] = torch.from_numpy(
                rel_position_index(ws, ws).reshape(-1)).to(device)
        return self._index[device]

    def forward(self, x, dtype):
        """NHWC `x` in `dtype` -> NHWC, the same shape."""
        n, ws = x.shape[0], self.window_size
        win, padded, pads = window_partition(x, ws)
        b, t, c = win.shape
        hd = c // self.num_heads
        qkv = linear(self.qkv, win, dtype).reshape(b, t, 3, self.num_heads,
                                                   hd)
        q, k, v = qkv.unbind(2)
        attn = torch.einsum('bqhd,bkhd->bhqk', at_least_f32(q * hd ** -0.5),
                            at_least_f32(k))
        bias = self.relative_position_bias_table.to(dtype)[
            self.position_index(x.device)].reshape(t, t, self.num_heads)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        attn = torch.softmax(attn, dim=-1).to(dtype)
        out = torch.einsum('bhqk,bkhd->bqhd', at_least_f32(attn),
                           at_least_f32(v))
        out = linear(self.proj, out.reshape(b, t, c).to(dtype), dtype)
        return window_merge(out, ws, padded, x.shape[1:3], pads, n)


class LocalWindowSelfAttention(nn.Module):
    """mmpose's wrapper of WindowMSA (the name `attn.attn`)."""

    def __init__(self, dim, num_heads, window_size):
        super().__init__()
        self.attn = WindowMSA(dim, num_heads, window_size)

    def forward(self, x, dtype):
        return self.attn(x, dtype)


class CrossFFN(nn.Module):
    """1x1 -> BN -> GELU -> depthwise 3x3 -> BN -> GELU -> 1x1 -> BN ->
    GELU on NCHW, exact GELU."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.norm1 = nn.BatchNorm2d(hidden)
        self.dw3x3 = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.norm2 = nn.BatchNorm2d(hidden)
        self.fc2 = nn.Conv2d(hidden, dim, 1)
        self.norm3 = nn.BatchNorm2d(dim)

    def forward(self, x, dtype):
        for conv, bn in ((self.fc1, self.norm1), (self.dw3x3, self.norm2),
                         (self.fc2, self.norm3)):
            x = F.gelu(norm(bn, conv2d(conv, x, dtype), dtype))
        return x


def _layer_norm(ln: nn.LayerNorm, x, dtype):
    """`ln` over the last axis in f32 (f64 in a float64 model), the result
    cast to `dtype` (flax's LayerNorm(dtype=...))."""
    return ln(at_least_f32(x)).to(dtype)


class HRFormerBlock(nn.Module):
    """LayerNorm -> window attention, LayerNorm -> CrossFFN, each added to
    its input; NCHW in and out, the attention on the NHWC view."""

    def __init__(self, dim, num_heads, window_size=7, mlp_ratio=4.0,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = LocalWindowSelfAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = CrossFFN(dim, int(dim * mlp_ratio))

    def forward(self, x):
        dt = self.dtype
        xh = x.permute(0, 2, 3, 1)
        xh = xh + self.attn(_layer_norm(self.norm1, xh, dt), dt)
        y = _layer_norm(self.norm2, xh, dt).permute(0, 3, 1, 2)
        return xh.permute(0, 3, 1, 2) + self.ffn(y, dt)


class HRFomerModule(nn.Module):
    """One module: `num_blocks` HRFormer blocks per branch, then the fusion
    (every target branch with `multiscale`, else branch 0 alone). The name
    keeps mmpose's spelling."""

    def __init__(self, channels, num_heads, mlp_ratios, window_size,
                 num_blocks, multiscale=True, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.branches = nn.ModuleList(
            nn.Sequential(*[HRFormerBlock(c, num_heads[b], window_size,
                                          mlp_ratios[b], dtype)
                            for _ in range(num_blocks)])
            for b, c in enumerate(channels))
        n = len(channels)
        rows = []
        for i in range(n if multiscale else 1):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        nn.Conv2d(channels[j], channels[i], 1, bias=False),
                        nn.BatchNorm2d(channels[i])))
                elif j == i:
                    row.append(None)
                else:
                    links = []
                    for d in range(i - j):
                        last = d == i - j - 1
                        c_in = channels[j]
                        c_out = channels[i] if last else c_in
                        links.append(nn.Sequential(
                            nn.Conv2d(c_in, c_in, 3, 2, 1, groups=c_in,
                                      bias=False),
                            nn.BatchNorm2d(c_in),
                            nn.Conv2d(c_in, c_out, 1, bias=False),
                            nn.BatchNorm2d(c_out),
                            *([] if last else [nn.ReLU()])))
                    row.append(nn.Sequential(*links))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        dt = self.dtype
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = outs[j]
                if j > i:
                    y = norm(layer[1], conv2d(layer[0], y, dt), dt)
                    y = F.interpolate(y, size=outs[i].shape[-2:],
                                      mode='bilinear', align_corners=False)
                elif j < i:
                    for link in layer:
                        y = norm(link[1], conv2d(link[0], y, dt), dt)
                        y = norm(link[3], conv2d(link[2], y, dt), dt,
                                 relu=len(link) == 5)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRFormer(nn.Module):
    """[N, H, W, 3] crops -> the highest-resolution branch [N, width, H/4,
    W/4] in the compute dtype (JAX HRFormer's arguments, `generator` for
    the seeded init)."""

    def __init__(self, width=32, num_heads=(1, 2, 4, 8), window_size=7,
                 stage_modules=(1, 2, 2), blocks_per_module=2,
                 mlp_ratios=(4, 4, 4, 4), dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.stage_modules = tuple(stage_modules)
        chans = (width, width * 2, width * 4, width * 8)
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if k == 0 else 256, 64,
                       downsample=(make_downsample(64, 256, 1, False)
                                   if k == 0 else None), dtype=dtype)
            for k in range(2)])
        self.transition1 = nn.ModuleList([
            _conv_bn(256, chans[0], 1, True),
            nn.Sequential(_conv_bn(256, chans[1], 2, True))])
        n_stages = len(self.stage_modules)
        for stage, n_mod in enumerate(self.stage_modules):
            n_br = stage + 2
            self.add_module(f'stage{stage + 2}', nn.Sequential(*[
                HRFomerModule(chans[:n_br], num_heads, mlp_ratios,
                              window_size, blocks_per_module,
                              multiscale=not (stage == n_stages - 1
                                              and m == n_mod - 1),
                              dtype=dtype)
                for m in range(n_mod)]))
            if stage < n_stages - 1:
                self.add_module(f'transition{stage + 2}', nn.ModuleList(
                    [None] * n_br + [nn.Sequential(_conv_bn(
                        chans[n_br - 1], chans[n_br], 2, True))]))
        self.out_channels = chans[0]
        init_cnn(self, generator)
        for name, p in self.named_parameters():
            if name.endswith('relative_position_bias_table'):
                normal_(p, 0.02, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        x = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        x = norm(self.bn2, conv2d(self.conv2, x, dt), dt, relu=True)
        x = self.layer1(x)
        xs = [_conv_bn_seq(self.transition1[0], x, dt),
              _conv_bn_seq(self.transition1[1][0], x, dt)]
        n_stages = len(self.stage_modules)
        for stage in range(n_stages):
            for module in getattr(self, f'stage{stage + 2}'):
                xs = module(xs)
            if stage < n_stages - 1:
                new = getattr(self, f'transition{stage + 2}')[-1][0]
                xs = xs + [_conv_bn_seq(new, xs[-1], dt)]
        return xs[0]
