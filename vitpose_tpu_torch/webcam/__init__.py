"""Webcam application framework: a threaded node graph for realtime pose.

The port's copy of vitpose_tpu/webcam/, the counterpart of the reference's
tools/webcam/webcam_apis package (webcam_runner.py, nodes/, utils/): frames
from a camera/video/image source flow through a graph of threaded nodes
connected by named buffers, with an event bus for keyboard hot-keys and
cross-node signals.

The simpler single-chain runner in vitpose_tpu_torch.api.webcam remains for
demos; this package is the full config-driven framework. Class and registry
names are JAX's, so every config under tools/webcam/configs/ loads as it
is.
"""
from .buffer import Buffer, BufferManager
from .event import EventManager
from .message import FrameMessage, Message, VideoEndingMessage
from .misc import (ImageCapture, copy_and_paste, expand_and_clamp,
                   is_image_file, limit_max_fps, load_image, screen_matting)
from .node import NODES, FrameDrawingNode, Node
from .pose_utils import (get_eye_keypoint_ids, get_face_keypoint_ids,
                         get_hand_keypoint_ids, get_mouth_keypoint_ids,
                         get_wrist_keypoint_ids)
from .runner import WebcamRunner

# Importing the node modules registers their classes with NODES.
from . import effect_nodes, helper_nodes, model_nodes  # noqa: F401,E402

__all__ = [
    'Buffer', 'BufferManager', 'EventManager', 'Message', 'FrameMessage',
    'VideoEndingMessage', 'Node', 'FrameDrawingNode', 'NODES',
    'WebcamRunner', 'limit_max_fps', 'is_image_file', 'ImageCapture',
    'load_image', 'screen_matting', 'copy_and_paste', 'expand_and_clamp',
    'get_eye_keypoint_ids', 'get_face_keypoint_ids',
    'get_wrist_keypoint_ids', 'get_mouth_keypoint_ids',
    'get_hand_keypoint_ids',
]
