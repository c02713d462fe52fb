"""Plain ViT backbone for top-down pose, in PyTorch.

Counterpart of vitpose_tpu/models/vit.py (`DropPath`, `Int8Dense`, `Mlp`,
`MoEMlp`, `Attention`, `Block`, `ViTConfig`, `VIT_VARIANTS`, `ViT`), with
the mmpose parameter names (`patch_embed.proj`,
`blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`,
`last_norm`; ViTPose+ adds `blocks.{i}.mlp.experts.{e}` in state dicts),
so a reference state dict loads as it is, into the float model and into
the int8 one (`Int8Linear` keeps nn.Linear's names).

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
import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import attention, keep_outputs

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


# the products without batch dimensions, the Linear layers: what 'dots'
# keeps, as JAX's dots_with_no_batch_dims_saveable does
_LINEAR_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_linear_outputs(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _LINEAR_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _keep_attention_output():
    tape = []
    return keep_outputs(tape, replay=False), keep_outputs(tape, replay=True)


# remat_policy -> checkpoint's context_fn (JAX models/vit.py:347-362); every
# op of a block whose output it does not keep runs again in the backward
# pass. 'full' keeps nothing. 'attn' keeps K3's output (JAX's 'attn_out'
# name, vit.py:209-213), so K1 does not run again. 'dots' keeps the Linear
# outputs by selective checkpointing; K1 runs again.
_REMAT_CONTEXT = {
    'full': None,
    'attn': _keep_attention_output,
    'dots': functools.partial(create_selective_checkpoint_contexts,
                              _keep_linear_outputs),
}


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


class Linear(nn.Linear):
    """nn.Linear applied in the compute dtype given at each call, its f32
    parameters cast (`linear`). A module call, so that forward hooks see
    its input and output (int8 calibration, the API's `outputs=`)."""

    def forward(self, x, dtype):
        return linear(self, x, dtype)


def int8_matmul(x_q, w_q):
    """The int32 product x_q @ w_q^T of int8 x_q [M, K] and int8 w_q [N, K]
    (row-major, nn.Linear's layout): `torch._int_mm` on the column-major
    view w_q^T, exact on both devices. JAX computes it with XLA's
    `dot_general` (vitpose_tpu/models/vit.py:87-89). CUDA takes M > 16 and
    K, N multiples of 8 and raises otherwise; nothing falls back to a float
    product. `launches` counts the calls on CUDA tensors."""
    if x_q.is_cuda:
        int8_matmul.launches += 1
    return torch._int_mm(x_q, w_q.t())


int8_matmul.launches = 0


# amax / 127 as XLA computes it in every jitted JAX program: a product with
# the f32 reciprocal. PyTorch's CUDA kernels turn a division by a Python
# scalar into the same product, where its CPU kernels divide; written as
# the product, both devices agree with JAX bit for bit.
_INV_127 = 1.0 / 127.0


class Int8Linear(Linear):
    """A Linear evaluated as a W8A8 int8 product: the counterpart of JAX
    `Int8Dense` (vitpose_tpu/models/vit.py:50-93), a serving-time option.

    The parameters are nn.Linear's (`weight` [out, in], `bias` [out]), so a
    float checkpoint loads as it is. The weight is quantised symmetrically
    per output channel (flax's axis 0 of [in, out] is dim 1 here):
    s_w = amax|W| * (1 / 127), w_q = round(W / max(s_w, 1e-12)); the codes are
    kept until the weight is loaded or moved again. Activations take the
    static absmax `act_scale` a (utils/quantize.py calibration):
    x_q = round(clip(x * (127 / a), +-127)), s_x = a / 127; with
    act_scale None, per token: s_x = amax|x| * (1 / 127), x_q = round(x /
    max(s_x, 1e-12)). The output is ((y_int32 * s_x) * s_w + bias) in f32,
    cast to the compute dtype. All in f32, rounding half to even, in JAX's
    order."""

    def __init__(self, in_features, out_features, bias=True, act_scale=None):
        super().__init__(in_features, out_features, bias)
        self.act_scale = None if act_scale is None else float(act_scale)
        self._codes = (None, None)

    def quantized_weight(self):
        """(w_q [out, in] int8, s_w [out] f32) of the current weight."""
        w = self.weight
        key = (w.device, w.data_ptr(), w._version)
        if self._codes[0] != key:
            with torch.no_grad():
                wf = w.float()
                s_w = wf.abs().amax(dim=1) * _INV_127
                w_q = torch.round(wf / s_w.clamp_min(1e-12)[:, None])
            self._codes = (key, (w_q.to(torch.int8), s_w))
        return self._codes[1]

    def quantize_input(self, x):
        """(x_q int8 of x's shape, s_x): a float for a static scale, else
        the per-token scales [..., 1]."""
        xf = x.float()
        if self.act_scale is not None:
            a = self.act_scale
            x_q = torch.round(torch.clamp(xf * (127.0 / a), -127.0, 127.0))
            s_x = a / 127.0
        else:
            s_x = xf.abs().amax(dim=-1, keepdim=True) * _INV_127
            x_q = torch.round(xf / s_x.clamp_min(1e-12))
        return x_q.to(torch.int8), s_x

    def forward(self, x, dtype):
        w_q, s_w = self.quantized_weight()
        x_q, s_x = self.quantize_input(x)
        lead, k = x.shape[:-1], x.shape[-1]
        y = int8_matmul(x_q.reshape(-1, k), w_q).float()
        if torch.is_tensor(s_x):
            s_x = s_x.reshape(-1, 1)
        y = y * s_x * s_w
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(dtype).reshape(*lead, -1)


def _dense(in_features, out_features, int8, act_scale=None, bias=True):
    return (Int8Linear(in_features, out_features, bias, act_scale) if int8
            else Linear(in_features, out_features, bias))


def init_linear(layer: nn.Linear, generator=None):
    normal_(layer.weight, layer.in_features ** -0.5, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


class DropPath(nn.Module):
    """Per-sample stochastic depth (reference vit.py:48); identity in eval.

    In training the mask is drawn from `generator`, a torch.Generator on the
    activations' device (the JAX module's 'droppath' rng), never from torch's
    global generator. `draw` and `drop` split the two halves, so that a
    caller can draw the masks before a checkpointed region (ViT.forward)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, x, generator=None):
        """The keep mask [N, 1, ...] for `x`, or None where nothing drops
        (rate 0 or eval mode)."""
        if self.rate == 0.0 or not self.training:
            return None
        if generator is None:
            raise ValueError('DropPath in training mode needs a '
                             'torch.Generator on the activations\' device')
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return torch.rand(shape, device=x.device,
                          generator=generator) < 1.0 - self.rate

    def drop(self, x, mask):
        if mask is None:
            return x
        keep = 1.0 - self.rate
        return torch.where(mask, x / keep, 0.0)

    def forward(self, x, generator=None):
        return self.drop(x, self.draw(x, generator))


class Mlp(nn.Module):
    """fc1, GELU, fc2; with `int8`, both products W8A8 (`Int8Linear`) at
    the static scales `act_scales[:2]` (fc1_in, fc2_in), or per token where
    they are None."""

    def __init__(self, dim, hidden_dim, gelu_approx=False, int8=False,
                 act_scales=None):
        super().__init__()
        a1, a2 = (act_scales or (None, None))[:2]
        self.fc1 = _dense(dim, hidden_dim, int8, a1)
        self.fc2 = _dense(hidden_dim, dim, int8, a2)
        self.gelu_approx = gelu_approx

    def forward(self, x, dtype):
        x = self.fc1(x, dtype)
        x = F.gelu(x, approximate='tanh' if self.gelu_approx else 'none')
        return self.fc2(x, dtype)


def expert_routing(expert_idx, n, num_experts, device):
    """A batch's expert indices as the MoE blocks take them: an int when
    every sample takes one expert (the runner's batches, which hold one
    dataset each), else [(expert, its rows as a tensor on `device`)].

    `expert_idx` is an int or one index per sample on the host (a numpy
    array or a list); a tensor raises, since reading it back would stall
    the card. The caller routes once per forward, so no block reads an
    index back."""
    if expert_idx is None:
        raise ValueError('a ViTPose+ (MoE) backbone needs expert_idx')
    if torch.is_tensor(expert_idx):
        raise TypeError('expert_idx must be an int or host indices (numpy '
                        'or a list), not a tensor')
    if isinstance(expert_idx, (int, np.integer)):
        idx = np.full(n, int(expert_idx))
    else:
        idx = np.asarray(expert_idx).reshape(-1)
    if idx.shape[0] != n or not ((idx >= 0) & (idx < num_experts)).all():
        raise ValueError(f'expert_idx {idx.tolist()}: expected {n} indices '
                         f'in [0, {num_experts})')
    experts = np.unique(idx)
    if len(experts) == 1:
        return int(experts[0])
    return [(int(e), torch.as_tensor(np.flatnonzero(idx == e),
                                     device=device)) for e in experts]


class MoEMlp(nn.Module):
    """The ViTPose+ FFN (JAX vit.py:123-163 `MoEMlp`, reference
    vit_moe.py:78): fc1 and GELU, then the shared `fc2` gives the first
    dim - part_dim channels and the sample's expert the last part_dim.

    The experts are stacked parameters, `expert_weight` [E, part, hidden]
    and `expert_bias` [E, part], as JAX stacks `expert_kernel` and
    `expert_bias`. So every step gives every expert a gradient, zeros where
    the batch did not select it, and AdamW moves and decays each expert as
    optax does; and the decay rule sees what JAX's sees (it decays the 2-D
    `expert_bias`, where mmpose's 1-D expert biases do not decay). State
    dicts carry the mmpose names `experts.{e}.weight` [part, hidden] and
    `experts.{e}.bias` [part]: the module writes and reads them.

    The expert product is one matmul per expert that the batch holds,
    over that expert's rows (`expert_routing`), not JAX's one-hot einsum,
    which builds per-sample [hidden, part] weights.
    """

    def __init__(self, dim, hidden_dim, num_experts, part_dim,
                 gelu_approx=False):
        super().__init__()
        self.part_dim = part_dim
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim - part_dim)
        self.expert_weight = nn.Parameter(
            torch.zeros(num_experts, part_dim, hidden_dim))
        self.expert_bias = nn.Parameter(torch.zeros(num_experts, part_dim))
        self.gelu_approx = gelu_approx
        self.register_state_dict_post_hook(_experts_to_mmpose)
        self.register_load_state_dict_pre_hook(_experts_from_mmpose)

    def forward(self, x, dtype, route):
        h = self.fc1(x, dtype)
        h = F.gelu(h, approximate='tanh' if self.gelu_approx else 'none')
        shared = self.fc2(h, dtype)
        w, b = self.expert_weight.to(dtype), self.expert_bias.to(dtype)
        if isinstance(route, int):
            part = F.linear(h, w[route], b[route])
        else:
            part = h.new_empty(h.shape[:-1] + (self.part_dim,))
            for e, rows in route:
                part[rows] = F.linear(h[rows], w[e], b[e])
        return torch.cat([shared, part], dim=-1)


def _experts_to_mmpose(module, state_dict, prefix, local_metadata):
    w = state_dict.pop(prefix + 'expert_weight')
    b = state_dict.pop(prefix + 'expert_bias')
    for e in range(w.shape[0]):
        state_dict[f'{prefix}experts.{e}.weight'] = w[e].clone()
        state_dict[f'{prefix}experts.{e}.bias'] = b[e].clone()


def _experts_from_mmpose(module, state_dict, prefix, *args):
    n = module.expert_weight.shape[0]
    keys = [(f'{prefix}experts.{e}.weight', f'{prefix}experts.{e}.bias')
            for e in range(n)]
    if all(k in state_dict for pair in keys for k in pair):
        state_dict[prefix + 'expert_weight'] = torch.stack(
            [state_dict.pop(w) for w, _ in keys])
        state_dict[prefix + 'expert_bias'] = torch.stack(
            [state_dict.pop(b) for _, b in keys])


class Attention(nn.Module):
    """Multi-head self-attention with one fused qkv projection.

    With `fused` the core goes through ops.attention.attention (K1 on CUDA,
    its plain version on the CPU); otherwise it runs the plain einsum path of
    vit.py:203-207, with q scaled in the compute dtype. With `int8` the qkv
    and proj products are W8A8 at the static scales `act_scales` (qkv_in,
    proj_in), or per token where they are None; q, k and v leave the qkv
    product in the compute dtype, so K1 runs between the two as it does
    without int8.
    """

    def __init__(self, dim, num_heads, qkv_bias=True, fused=False,
                 int8=False, act_scales=None):
        super().__init__()
        aq, ap = (act_scales or (None, None))[:2]
        self.num_heads = num_heads
        self.fused = fused
        self.qkv = _dense(dim, 3 * dim, int8, aq, bias=qkv_bias)
        self.proj = _dense(dim, dim, int8, ap)

    def forward(self, x, dtype):
        n, t, d = x.shape
        hd = d // self.num_heads
        qkv = self.qkv(x, dtype).reshape(n, t, 3, self.num_heads, hd)
        q, k, v = qkv.unbind(2)                      # [N, T, H, hd] views
        if self.fused:
            out = attention(q, k, v)
        else:
            s = torch.einsum('nqhd,nkhd->nhqk', (q * hd ** -0.5).float(),
                             k.float())
            p = torch.softmax(s, dim=-1).to(dtype)
            out = torch.einsum('nhqk,nkhd->nqhd', p.float(), v.float())
        # the proj input is what JAX sows as 'proj_in' (vit.py:214-216),
        # read by utils/quantize.py calibration through a hook on proj
        return self.proj(out.reshape(n, t, d).to(dtype), dtype)


class Block(nn.Module):
    """`int8_act_scales`: the block's static absmax, (fc1_in, fc2_in) or
    (fc1_in, fc2_in, qkv_in, proj_in), as JAX's Block takes them
    (vit.py:231-259)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 fused_attention=False, drop_path=0.0, gelu_approx=False,
                 num_experts=0, part_dim=0, int8_mlp=False, int8_qkv=False,
                 int8_act_scales=None):
        super().__init__()
        scales = tuple(int8_act_scales or ())
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, fused_attention,
                              int8_qkv,
                              scales[2:4] if len(scales) >= 4 else None)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        hidden = int(dim * mlp_ratio)
        self.mlp = (MoEMlp(dim, hidden, num_experts, part_dim, gelu_approx)
                    if num_experts > 0
                    else Mlp(dim, hidden, gelu_approx, int8_mlp,
                             int8_act_scales))

    def draw_masks(self, x, generator=None):
        """The DropPath masks of the two branches, in the order forward
        would draw them."""
        return (self.drop_path.draw(x, generator),
                self.drop_path.draw(x, generator))

    def forward(self, x, dtype, masks=(None, None), route=None):
        """`route`: the batch's `expert_routing` in an MoE block."""
        y = self.attn(self.norm1(x.float()).to(dtype), dtype)
        x = x + self.drop_path.drop(y, masks[0])
        y = self.norm2(x.float()).to(dtype)
        y = self.mlp(y, dtype) if route is None else self.mlp(y, dtype, route)
        return x + self.drop_path.drop(y, masks[1])


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
    int8_mlp: bool = False              # W8A8 MLP products (serving-time)
    int8_qkv: bool = False              # W8A8 qkv/proj products too
    # static per-block activation absmax from utils/quantize.py: one
    # (fc1_in, fc2_in) or (fc1_in, fc2_in, qkv_in, proj_in) tuple per
    # block; () => dynamic per token
    int8_act_scales: tuple = ()
    # block indices kept in the float path under int8_mlp/int8_qkv
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
    if cfg.num_experts > 0 and (cfg.int8_mlp or cfg.int8_qkv):
        # JAX refuses it in int8_serving_config (vitpose_tpu/utils/
        # quantize.py:105-110): MoEMlp has no int8 path
        raise NotImplementedError(
            'int8 serving is not implemented for MoE (num_experts > 0) '
            'backbones: MoEMlp has no int8 path')
    if cfg.int8_act_scales and len(cfg.int8_act_scales) != cfg.depth:
        raise ValueError(f'int8_act_scales holds '
                         f'{len(cfg.int8_act_scales)} blocks, expected '
                         f'{cfg.depth}')
    if cfg.remat_blocks and cfg.remat_policy not in _REMAT_CONTEXT:
        raise ValueError(f'remat_policy {cfg.remat_policy!r}: expected '
                         "'full', 'attn', or 'dots'")
    if cfg.remat_blocks and cfg.remat_policy == 'attn' \
            and not cfg.fused_attention:
        raise NotImplementedError(
            "remat_policy 'attn' keeps K3's output and needs "
            'fused_attention=True; the plain einsum path under it is not '
            'ported yet (ROADMAP.md queue 1 item 7)')


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
        skip8 = set(cfg.int8_skip_blocks)
        self.blocks = nn.ModuleList([
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                  cfg.fused_attention, float(dpr[i]), cfg.gelu_approx,
                  cfg.num_experts, cfg.part_dim,
                  int8_mlp=cfg.int8_mlp and i not in skip8,
                  int8_qkv=cfg.int8_qkv and i not in skip8,
                  int8_act_scales=(cfg.int8_act_scales[i]
                                   if cfg.int8_act_scales else None))
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
            if isinstance(blk.mlp, MoEMlp):
                # flax's lecun_normal on JAX's [E, hidden, part] kernel takes
                # E * hidden as its fan-in
                w = blk.mlp.expert_weight
                normal_(w, (w.shape[0] * w.shape[2]) ** -0.5, generator)
                nn.init.zeros_(blk.mlp.expert_bias)
            for norm in (blk.norm1, blk.norm2):
                norm.reset_parameters()
        self.last_norm.reset_parameters()

    def forward(self, x, generator=None, expert_idx=None):
        """`generator` feeds DropPath in training mode (see DropPath): the
        masks are drawn block by block, attention branch first, in the
        order the blocks use them. `expert_idx` picks each sample's expert
        in a ViTPose+ backbone (see `expert_routing`); a plain one ignores
        it, as JAX's does."""
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
        route = (expert_routing(expert_idx, n, self.cfg.num_experts,
                                x.device)
                 if self.cfg.num_experts > 0 else None)
        for blk in self.blocks:
            x = self._block(blk, x, dtype, blk.draw_masks(x, generator),
                            route)
        x = self.last_norm(x.float()).to(dtype)
        return x.reshape(n, hp, wp, d)

    def _block(self, blk, x, dtype, masks, route):
        """One block; under `remat_blocks`, while a gradient is recorded, a
        non-reentrant checkpoint that keeps the block's inputs and what
        its policy keeps. The DropPath masks are drawn before it from the
        caller's generator, whose state a recompute would not restore, so
        no random draw happens inside and no RNG state is stashed."""
        if not (self.cfg.remat_blocks and torch.is_grad_enabled()):
            return blk(x, dtype, masks, route)
        context = _REMAT_CONTEXT[self.cfg.remat_policy]
        kw = {} if context is None else {'context_fn': context}
        return checkpoint(blk, x, dtype, masks, route, use_reentrant=False,
                          preserve_rng_state=False, **kw)
