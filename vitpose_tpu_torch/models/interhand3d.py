"""The interacting-hand 3D estimator (InterNet), in PyTorch.

Counterpart of vitpose_tpu/models/interhand3d.py (`Interhand3DEstimator`
:23, `decode` :105, `interhand3d_losses` :133, `backproject_to_camera`
:182; reference mmpose detectors/interhand_3d.py): a trunk (the zoo's
ResNet-50, or a ViT) and `Interhand3DHead` under mmpose's names
(`backbone.*`, `keypoint_head.*`). `forward` gives the 2.5D volumes
[N, 42, D, H, W], the root-depth logits and the hand-type logits; in
training mode the BN statistics move in place (flax's semantics), as
JAX's `train_apply` returns them. `decode` takes the volumes' argmax to
image pixels and depth millimetres, the root depth by the soft-argmax over
its bins, the hand type by a sigmoid; `backproject_to_camera` (host numpy)
lifts the pixels to root-relative camera millimetres.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.decode import heatmaps3d_to_coords
from ..ops.geometry import transform_preds
from .heads_extra import Interhand3DHead
from .losses import bce_loss, joints_mse_loss, l1_loss
from .vit import ViT

R_WRIST, L_WRIST = 20, 41


class Interhand3DEstimator(torch.nn.Module):
    def __init__(self, backbone, num_joints=42, depth_size=64,
                 heatmap_size=(64, 64), depth_range_mm=400.0,
                 root_depth_range_mm=400.0, split_hands=False,
                 deconv_filters=(256, 256), root_depth_bins=64,
                 image_size=(256, 256), backbone_type='resnet',
                 generator=None):
        """`backbone`: an NHWC-in module giving NCHW features with
        `out_channels` (a CNN of train.loop.build_backbone, its
        `backbone_type`) or the ViT (NHWC features); `image_size` (w, h) is
        the crop the API cuts (a ViT's own img_size wins)."""
        super().__init__()
        self.backbone = backbone
        self.backbone_type = 'vit' if isinstance(backbone, ViT) \
            else backbone_type
        channels = (backbone.cfg.embed_dim if isinstance(backbone, ViT)
                    else backbone.out_channels)
        self.keypoint_head = Interhand3DHead(
            channels, num_joints, depth_size, root_depth_bins,
            deconv_filters, split_hands, generator=generator)
        self.num_joints = num_joints
        self.depth_size = depth_size
        self.heatmap_size = tuple(heatmap_size)
        self.depth_range = depth_range_mm
        self.root_depth_range = root_depth_range_mm
        self.image_size = (tuple(backbone.cfg.img_size[::-1])
                           if isinstance(backbone, ViT)
                           else tuple(image_size))

    def forward(self, imgs):
        """[N, H, W, 3] crops -> (heatmaps3d, root logits, hand-type
        logits)."""
        feat = self.backbone(imgs)
        if isinstance(self.backbone, ViT):
            feat = feat.permute(0, 3, 1, 2)
        return self.keypoint_head(feat)

    @torch.no_grad()
    def infer(self, imgs):
        """The eval-mode forward (the module's mode restored after)."""
        was = self.training
        self.eval()
        try:
            return self(imgs)
        finally:
            self.train(was)

    @torch.no_grad()
    def decode(self, hm3d, root_depth_logits, hand_type_logits, center,
               scale):
        """Volumes -> dict(keypoints_3d [N, K, 3] (image x, y, depth mm),
        scores [N, K, 1], rel_root_depth [N] mm, hand_type [N, 2]
        probabilities), as numpy."""
        dev = hm3d.device
        coords, maxvals = heatmaps3d_to_coords(hm3d.float())
        w, h = hm3d.shape[4], hm3d.shape[3]
        xy = transform_preds(coords[..., :2],
                             torch.as_tensor(center, dtype=torch.float32,
                                             device=dev),
                             torch.as_tensor(scale, dtype=torch.float32,
                                             device=dev), (w, h))
        z = (coords[..., 2] / self.depth_size - 0.5) * self.depth_range
        kp = torch.cat([xy, z[..., None]], dim=-1)
        logits = root_depth_logits.float()
        bins = logits.shape[-1]
        probs = torch.softmax(logits, dim=-1)
        root = (probs * torch.arange(bins, dtype=probs.dtype,
                                     device=dev)).sum(-1)
        rel_root = (root / bins - 0.5) * self.root_depth_range
        return dict(keypoints_3d=kp.cpu().numpy(),
                    scores=maxvals.cpu().numpy(),
                    rel_root_depth=rel_root.cpu().numpy(),
                    hand_type=torch.sigmoid(hand_type_logits.float())
                    .cpu().numpy())


def interhand3d_losses(outputs, target_hm3d, hm_weight, rel_root_depth,
                       root_weight, hand_type, type_weight,
                       root_depth_bins=64, root_depth_range_mm=400.0):
    """The three sub-heads' losses (reference interhand_3d_head.py:333):
    dict(hand_loss: joints MSE on the volumes, rel_root_loss: L1 on the
    soft-argmax root depth in bin units (targets outside the bins carry no
    weight), hand_type_loss: BCE on the hand-type probabilities)."""
    hm3d, root_logits, type_logits = outputs
    n, k, d, h, w = hm3d.shape
    hand_loss = joints_mse_loss(hm3d.reshape(n, k, d * h, w),
                                target_hm3d.reshape(n, k, d * h, w),
                                hm_weight.reshape(n, k))
    bins = root_logits.shape[-1]
    soft = torch.softmax(root_logits, dim=-1)
    pred_bins = (soft * torch.arange(bins, dtype=torch.float32,
                                     device=soft.device)).sum(-1)
    target_bins = (rel_root_depth / root_depth_range_mm + 0.5) \
        * root_depth_bins
    in_range = ((target_bins >= 0)
                & (target_bins <= root_depth_bins)).float()
    rel_root_loss = l1_loss(pred_bins, target_bins, root_weight * in_range)
    hand_type_loss = bce_loss(torch.sigmoid(type_logits), hand_type,
                              type_weight)
    return dict(hand_loss=hand_loss, rel_root_loss=rel_root_loss,
                hand_type_loss=hand_type_loss)


def backproject_to_camera(keypoints_3d, focal, princpt, abs_depth):
    """Decoded [N, K, 3] (pixel x, y, root-relative depth mm) and the
    absolute root depths [N, 2] (right, left wrist) -> root-relative camera
    millimetres [N, K, 3], float64 on the host."""
    kp = np.asarray(keypoints_3d, np.float64).copy()
    focal = np.asarray(focal, np.float64).reshape(-1, 2)
    princpt = np.asarray(princpt, np.float64).reshape(-1, 2)
    abs_depth = np.asarray(abs_depth, np.float64).reshape(-1, 2)
    out = np.zeros_like(kp)
    for i in range(kp.shape[0]):
        z_abs = kp[i, :, 2].copy()
        z_abs[:21] += abs_depth[i % len(abs_depth), 0]
        z_abs[21:] += abs_depth[i % len(abs_depth), 1]
        f = focal[i % len(focal)]
        c = princpt[i % len(princpt)]
        x = (kp[i, :, 0] - c[0]) / f[0] * z_abs
        y = (kp[i, :, 1] - c[1]) / f[1] * z_abs
        cam = np.stack([x, y, z_abs], axis=1)
        cam[:21] -= cam[R_WRIST]
        cam[21:] -= cam[L_WRIST]
        out[i] = cam
    return out
