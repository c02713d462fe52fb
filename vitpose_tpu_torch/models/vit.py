"""Plain ViT backbone for top-down pose, in PyTorch.

Counterpart of vitpose_tpu/models/vit.py (`DropPath`, `Mlp`, `Attention`,
`Block`, `ViTConfig`, `VIT_VARIANTS`, `ViT`), with the mmpose parameter names
(`patch_embed.proj`, `blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}`, `last_norm`), so a reference state dict loads as it is.

Precision follows flax's `dtype`: parameters are stored in f32 and cast to
the compute dtype at each use (explicit casts, not autocast), so gradients
flow back into the f32 parameters through the casts. LayerNorm
computes its statistics and affine in f32 and casts the result, as flax does.
Where the rounding differs from flax: a bf16 Linear or conv rounds once after
adding its bias (flax rounds the product, then the sum), and GELU rounds once
from f32.

The input is NHWC, as in the JAX package; the output is the NHWC feature map
[N, Hp, Wp, D].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


def compute_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def normal_(tensor, std, generator=None):
    """In-place normal init cut at two standard deviations; kernels use
    std = fan_in ** -0.5, flax's default (lecun normal)."""
    with torch.no_grad():
        sample = torch.randn(tensor.shape, generator=generator)
        tensor.copy_(sample.clamp_(-2.0, 2.0) * std)
    return tensor


def linear(layer: nn.Linear, x, dtype):
    """`layer` applied in `dtype`, with its f32 parameters cast."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x, layer.weight.to(dtype), bias)


def init_linear(layer: nn.Linear, generator=None):
    normal_(layer.weight, layer.in_features ** -0.5, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


class DropPath(nn.Module):
    """Per-sample stochastic depth (reference vit.py:48); identity in eval.

    In training the mask is drawn from `generator`, a torch.Generator on the
    activations' device (the JAX module's 'droppath' rng), never from torch's
    global generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError('DropPath in training mode needs a '
                             'torch.Generator on the activations\' device')
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, device=x.device, generator=generator) < keep
        return torch.where(mask, x / keep, 0.0)


class Mlp(nn.Module):
    def __init__(self, dim, hidden_dim, gelu_approx=False):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.gelu_approx = gelu_approx

    def forward(self, x, dtype):
        x = linear(self.fc1, x, dtype)
        x = F.gelu(x, approximate='tanh' if self.gelu_approx else 'none')
        return linear(self.fc2, x, dtype)


class Attention(nn.Module):
    """Multi-head self-attention with one fused qkv projection.

    With `fused` the core goes through ops.attention.attention (K1 on CUDA,
    its plain version on the CPU); otherwise it runs the plain einsum path of
    vit.py:203-207, with q scaled in the compute dtype.
    """

    def __init__(self, dim, num_heads, qkv_bias=True, fused=False):
        super().__init__()
        self.num_heads = num_heads
        self.fused = fused
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, dtype):
        n, t, d = x.shape
        hd = d // self.num_heads
        qkv = linear(self.qkv, x, dtype).reshape(n, t, 3, self.num_heads, hd)
        q, k, v = qkv.unbind(2)                      # [N, T, H, hd] views
        if self.fused:
            out = attention(q, k, v)
        else:
            s = torch.einsum('nqhd,nkhd->nhqk', (q * hd ** -0.5).float(),
                             k.float())
            p = torch.softmax(s, dim=-1).to(dtype)
            out = torch.einsum('nhqk,nkhd->nqhd', p.float(), v.float())
        return linear(self.proj, out.reshape(n, t, d).to(dtype), dtype)


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 fused_attention=False, drop_path=0.0, gelu_approx=False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, fused_attention)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_approx)

    def forward(self, x, dtype, generator=None):
        y = self.attn(self.norm1(x.float()).to(dtype), dtype)
        x = x + self.drop_path(y, generator)
        y = self.mlp(self.norm2(x.float()).to(dtype), dtype)
        return x + self.drop_path(y, generator)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: tuple = (256, 192)        # (H, W)
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.0
    num_experts: int = 0
    part_dim: int = 0
    remat_blocks: bool = False
    remat_policy: str = 'full'
    fused_attention: bool = False       # K1 kernel on CUDA
    gelu_approx: bool = False           # tanh GELU (serving-time option)
    int8_mlp: bool = False
    int8_qkv: bool = False
    int8_act_scales: tuple = ()
    int8_skip_blocks: tuple = ()
    dtype: str = 'float32'

    @property
    def grid(self):
        # conv padding 2 on each side, stride = patch (reference vit.py:157)
        h = (self.img_size[0] + 4 - self.patch_size) // self.patch_size + 1
        w = (self.img_size[1] + 4 - self.patch_size) // self.patch_size + 1
        return h, w

    @property
    def num_patches(self):
        h, w = self.grid
        return h * w


VIT_VARIANTS = {
    's': dict(embed_dim=384, depth=12, num_heads=12, drop_path_rate=0.1),
    'b': dict(embed_dim=768, depth=12, num_heads=12, drop_path_rate=0.3),
    'l': dict(embed_dim=1024, depth=24, num_heads=16, drop_path_rate=0.5),
    'h': dict(embed_dim=1280, depth=32, num_heads=16, drop_path_rate=0.55),
}


def _check_ported(cfg: ViTConfig):
    if cfg.int8_mlp or cfg.int8_qkv or cfg.int8_act_scales:
        raise NotImplementedError('int8 W8A8 serving is not ported yet '
                                  '(ROADMAP.md queue 1 item 8)')
    if cfg.num_experts > 0:
        raise NotImplementedError('the ViTPose+ MoE MLP is not ported yet '
                                  '(ROADMAP.md queue 1 item 10)')
    if cfg.remat_blocks:
        raise NotImplementedError('block rematerialisation is not ported yet '
                                  '(ROADMAP.md queue 1 item 7); no shipped '
                                  'config sets it')


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size,
                              padding=2)


class ViT(nn.Module):
    """Window-free plain ViT: [N, H, W, 3] -> [N, Hp, Wp, D]."""

    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList([
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                  cfg.fused_attention, float(dpr[i]), cfg.gelu_approx)
            for i in range(cfg.depth)])
        self.last_norm = nn.LayerNorm(d, eps=1e-6)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        p = self.cfg.patch_size
        proj = self.patch_embed.proj
        normal_(proj.weight, (3 * p * p) ** -0.5, generator)
        nn.init.zeros_(proj.bias)
        normal_(self.pos_embed, 0.02, generator)
        for blk in self.blocks:
            for layer in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1,
                          blk.mlp.fc2):
                init_linear(layer, generator)
            for norm in (blk.norm1, blk.norm2):
                norm.reset_parameters()
        self.last_norm.reset_parameters()

    def forward(self, x, generator=None):
        """`generator` feeds DropPath in training mode (see DropPath)."""
        dtype = compute_dtype(self.cfg.dtype)
        proj = self.patch_embed.proj
        x = x.to(dtype).permute(0, 3, 1, 2)
        x = F.conv2d(x, proj.weight.to(dtype), proj.bias.to(dtype),
                     stride=proj.stride, padding=proj.padding)
        n, d, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2)             # [N, T, D]
        pos = self.pos_embed.to(dtype)
        # keep the cls-token slot additive, as the pretrained weights expect
        x = x + pos[:, 1:] + pos[:, :1]
        for blk in self.blocks:
            x = blk(x, dtype, generator)
        x = self.last_norm(x.float()).to(dtype)
        return x.reshape(n, hp, wp, d)
