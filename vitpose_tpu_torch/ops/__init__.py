"""Tensor ops of the port: attention (K1, K2, K3 and their plain versions),
crop geometry, the batched warp, heatmap decoding and training targets.

The attention functions stay in their module (``ops.attention``), whose name
the package does not shadow."""
from .decode import keypoints_from_heatmaps, pose_pck_accuracy
from .geometry import (affine_matrix, apply_affine_to_points, bbox_xywh2cs,
                       bbox_xyxy2xywh, flip_back, flip_index_from_pairs,
                       invert_affine, transform_preds, udp_warp_matrix)
from .target import generate_msra_heatmaps, generate_udp_heatmaps
from .warp import warp_affine_batch
