"""Tensor ops of the port: attention (K1 and its plain version), crop
geometry, the batched warp and heatmap decoding.

The attention functions stay in their module (``ops.attention``), whose name
the package does not shadow."""
from .decode import keypoints_from_heatmaps
from .geometry import (affine_matrix, bbox_xywh2cs, bbox_xyxy2xywh,
                       flip_back, flip_index_from_pairs, invert_affine,
                       transform_preds, udp_warp_matrix)
from .warp import warp_affine_batch
