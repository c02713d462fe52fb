"""User-facing API of the port: the JAX package's top-down surface
(vitpose_tpu/api/__init__.py, the reference `mmpose.apis` exports).
`run_validation` is the single-process `single_gpu_test` counterpart
(eval/loop.py); `train_model` lives in train/loop.py."""
from ..eval.loop import run_validation
from ..parallel.distributed import init_random_seed
from ..train.loop import train_model
from .inference import (PoseModel, imshow_bboxes,
                        inference_top_down_pose_model, init_pose_model,
                        load_checkpoint, process_mmdet_results,
                        vis_pose_result)
from .tracking import get_track_id, vis_pose_tracking_result

__all__ = [
    'train_model', 'init_pose_model', 'inference_top_down_pose_model',
    'run_validation', 'vis_pose_result', 'get_track_id',
    'vis_pose_tracking_result', 'process_mmdet_results', 'init_random_seed',
]
