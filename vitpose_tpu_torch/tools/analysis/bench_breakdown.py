"""Where the serving time goes: the matmul ceiling, the backbone with K1
and with the plain attention, the head, the normalisation and the decode.

    python -m vitpose_tpu_torch.tools.analysis.bench_breakdown
        [--batch 256] [--group 4] [--iters 3] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/bench_breakdown.py; one
JSON line per experiment with JAX's keys {exp, per_sec, ms_per_iter, unit}
and the card's name and power limit under 'card':

  matmul_ceiling      8 chained [B*192, 768] x [768, 3072] bf16 products,
                      each sliced back to 768 columns (torch.matmul: JAX's
                      is plain XLA too), TFLOP/s
  e2e_fused_decode    uint8 crops normalised on the card, ViTPose-B bf16
                      with K1, the UDP decode on the card
                      (`keypoints_from_heatmaps`, post_process 'default')
  e2e_fused_nodecode  the same without the decode
  backbone_fused      the ViT alone, K1
  backbone_plain_attn the ViT alone with the plain attention
                      (`alias`: JAX's backbone_xla_attn)
  e2e_plain_decode    e2e with the plain attention (`alias`: JAX's
                      e2e_xla_decode)
  e2e_fused_group1    e2e_fused_decode at one batch per timed call
  decode_only         the decode of [B, 17, 64, 48] f32 maps

Each timed call runs GROUP batches of BATCH crops back to back, as JAX
scans them in one dispatch (no CUDA graph); the model's weights are drawn
from seed 0 (the same for both attentions). One warm-up call, then ITERS
calls on distinct inputs, each between CUDA events (the host clock on the
CPU); JAX syncs on a host readback of one element, which this does not
copy. `--img-size H W` and `--backbone KEY=VALUE ...` (ViTConfig fields)
shrink the model for a run on the CPU.
"""
from __future__ import annotations

import argparse

import torch

from ...api.inference import _device
from ...data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ...ops.decode import keypoints_from_heatmaps
from ._common import (Launches, backbone_options, device_randn, timeit,
                      vit_model)

BATCH = 256
GROUP = 4
WARMUP = 1
ITERS = 3


def make_e2e(model, center, scale, with_decode=True, backbone_only=False):
    """run(group of uint8 crops [G, N, H, W, 3]) -> per batch the decoded
    keypoints, or with `with_decode` False a corner of the heatmaps (or of
    the ViT's features with `backbone_only`)."""
    dev = center.device
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)

    def run(g):
        outs = []
        with torch.inference_mode():
            for u8 in g:
                x = (u8.float() / 255.0 - mean) / std
                hm = model.backbone(x) if backbone_only else model(x)
                if with_decode:
                    outs.append(keypoints_from_heatmaps(
                        hm, center, scale, post_process='default',
                        use_udp=True)[0])
                else:
                    outs.append(hm[..., :1, :1] if hm.dim() == 4 else hm)
        return outs
    return run


def decode_group(center, scale):
    """run(group of heatmaps [G, N, K, h, w]) -> per batch the keypoints."""
    def run(g):
        with torch.inference_mode():
            return [keypoints_from_heatmaps(hm, center, scale,
                                            post_process='default',
                                            use_udp=True)[0] for hm in g]
    return run


def main(argv=None):
    """Print one JSON line per experiment; returns {'lines': [...],
    'launches': {exp: {'k1', 'k2'}}}."""
    ap = argparse.ArgumentParser(description='serving time by component '
                                 '(PyTorch port)')
    ap.add_argument('--batch', type=int, default=BATCH)
    ap.add_argument('--group', type=int, default=GROUP)
    ap.add_argument('--iters', type=int, default=ITERS)
    ap.add_argument('--img-size', type=int, nargs=2, default=(256, 192))
    ap.add_argument('--backbone', nargs='*', default=[],
                    help='ViTConfig fields as KEY=VALUE (small CPU runs)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    batch, group, iters, hw = (args.batch, args.group, args.iters,
                               tuple(args.img_size))
    n_in = WARMUP + iters
    over = backbone_options(args.backbone)
    model_f = vit_model('b', dev, hw, 'bfloat16', True, over)
    model_x = vit_model('b', dev, hw, 'bfloat16', False, over)
    lines, launches = [], {}

    def timed(name, fn, inputs, work, unit='imgs/sec', alias=None):
        with Launches() as counted:
            lines.append(timeit(name, fn, inputs, work, dev, unit, WARMUP,
                                iters, alias and {'alias': alias}))
        launches[name] = counted.counts()

    # 0) the matmul ceiling: the MLP fc1 product of the ViT at this batch
    bb = model_f.cfg.backbone
    m = batch * bb.grid[0] * bb.grid[1]
    k, n2 = bb.embed_dim, int(bb.embed_dim * bb.mlp_ratio)
    mats = [(device_randn((m, k), i, dev, torch.bfloat16),
             device_randn((k, n2), 100 + i, dev, torch.bfloat16))
            for i in range(n_in)]

    def mm(ab):
        a, b = ab
        x = a
        for _ in range(8):
            x = torch.matmul(x, b)[:, :k]
        return x
    timed('matmul_ceiling', mm, mats, 8 * 2 * m * k * n2 / 1e12, 'TFLOP/s')
    del mats

    gen = torch.Generator(device=dev).manual_seed(0)
    imgs = [torch.randint(0, 255, (group, batch, *hw, 3), generator=gen,
                          device=dev, dtype=torch.uint8)
            for _ in range(n_in)]
    center = torch.tensor([[320.0, 240.0]], device=dev).repeat(batch, 1)
    scale = torch.tensor([[1.2, 1.6]], device=dev).repeat(batch, 1)
    work = group * batch
    timed('e2e_fused_decode', make_e2e(model_f, center, scale), imgs, work)
    timed('e2e_fused_nodecode',
          make_e2e(model_f, center, scale, with_decode=False), imgs, work)
    timed('backbone_fused', make_e2e(model_f, center, scale, False, True),
          imgs, work)
    timed('backbone_plain_attn',
          make_e2e(model_x, center, scale, False, True), imgs, work,
          alias='backbone_xla_attn')
    timed('e2e_plain_decode', make_e2e(model_x, center, scale), imgs, work,
          alias='e2e_xla_decode')
    # the host's share: the same program at one batch per timed call
    timed('e2e_fused_group1', make_e2e(model_f, center, scale),
          [x[:1] for x in imgs], batch)
    del imgs

    hms = [device_randn((group, batch, 17, hw[0] // 4, hw[1] // 4), i, dev)
           for i in range(n_in)]
    timed('decode_only', decode_group(center, scale), hms, work)
    return {'lines': lines, 'launches': launches}


if __name__ == '__main__':
    main()
