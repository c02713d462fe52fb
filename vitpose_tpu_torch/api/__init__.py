"""User-facing API of the port: the JAX package's top-down, bottom-up and
pose-lifting surface (vitpose_tpu/api/__init__.py, the reference `mmpose.apis` exports).
`run_validation` is the single-process `single_gpu_test` counterpart and
`collect_results` gathers its results over processes (eval/loop.py);
`train_model` lives in train/loop.py."""
from ..eval.loop import collect_results, run_validation
from ..parallel.distributed import init_random_seed
from ..train.loop import train_model
from .inference import (PoseModel, imshow_bboxes,
                        inference_bottom_up_multi_scale,
                        inference_bottom_up_pose_model,
                        inference_top_down_pose_model, init_pose_model,
                        load_checkpoint, process_mmdet_results,
                        vis_pose_result)
from .inference_3d import (extract_pose_sequence,
                           inference_pose_lifter_model, vis_3d_pose_result)
from .tracking import get_track_id, vis_pose_tracking_result

__all__ = [
    'train_model', 'init_pose_model', 'inference_top_down_pose_model',
    'inference_bottom_up_pose_model', 'inference_bottom_up_multi_scale',
    'run_validation', 'vis_pose_result', 'get_track_id',
    'vis_pose_tracking_result', 'process_mmdet_results', 'init_random_seed',
    'extract_pose_sequence', 'inference_pose_lifter_model',
    'vis_3d_pose_result', 'collect_results',
]
