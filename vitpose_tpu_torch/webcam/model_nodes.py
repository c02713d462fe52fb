"""Model-inference nodes.

The port's copy of vitpose_tpu/webcam/model_nodes.py (the reference
tools/webcam/webcam_apis/nodes/mmdet_node.py and mmpose_node.py). The
detector slot is pluggable (the reference requires mmdet; here any callable
works, with a whole-frame fallback so pose-only apps run detector-free), and
the pose node runs `inference_top_down_pose_model` of
vitpose_tpu_torch.api.inference on its own thread, on CUDA by default: K1
launches there where the model config turns fused attention on (a config
file such as vitpose_tpu/configs/coco/vitpose_b_coco_256x192.py, or a dict
with dtype='bfloat16' and backbone_overrides={'fused_attention': True}).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from .message import Message
from .node import NODES, Node


@NODES.register_module()
class DetectorNode(Node):
    """Object detection (reference mmdet_node.py:15).

    `detector` may be:
      * None — emit one whole-frame 'person' box (pose-only apps);
      * a callable frame -> list of {'cls_id', 'label', 'bbox' xyxy+score,
        'mask'} dicts;
      * a dict config with a 'build' callable returning such a callable.
    Results are added as a tagged detection result with the node's name.
    """

    def __init__(self, name: str,
                 input_buffer: str,
                 output_buffer: Union[str, List[str]],
                 detector: Optional[Union[Callable, Dict]] = None,
                 enable_key: Optional[Union[str, int]] = None,
                 bbox_thr: float = 0.5):
        super().__init__(name=name, enable_key=enable_key, enable=True)
        if isinstance(detector, dict):
            cfg = dict(detector)
            detector = cfg.pop('build')(**cfg)
        self.detector = detector
        self.bbox_thr = bbox_thr
        self.register_input_buffer(input_buffer, 'input', essential=True)
        self.register_output_buffer(output_buffer)

    def bypass(self, input_msgs):
        return input_msgs['input']

    def process(self, input_msgs: Dict[str, Message]) -> Message:
        input_msg = input_msgs['input']
        img = input_msg.get_image()
        if self.detector is None:
            h, w = img.shape[:2]
            preds = [{'cls_id': 0, 'label': 'person',
                      'bbox': np.array([0, 0, w, h, 1.0], np.float32),
                      'mask': None}]
        else:
            preds = [dict(p) for p in self.detector(img)]
            for p in preds:
                p.setdefault('mask', None)
        input_msg.add_detection_result({'preds': preds}, tag=self.name)
        return input_msg


@NODES.register_module()
class TopDownPoseEstimatorNode(Node):
    """Top-down pose on detected boxes (reference mmpose_node.py:13), with
    the same smoothed IoU tracking (get_track_id use_one_euro=True)."""

    def __init__(self, name: str,
                 model_config,
                 input_buffer: str,
                 output_buffer: Union[str, List[str]],
                 model_checkpoint: Optional[str] = None,
                 enable_key: Optional[Union[str, int]] = None,
                 enable: bool = True,
                 device: str = 'cuda',
                 cls_ids: Optional[List[int]] = None,
                 cls_names: Optional[List[str]] = None,
                 bbox_thr: float = 0.5):
        super().__init__(name=name, enable_key=enable_key, enable=enable)
        from ..api.inference import init_pose_model
        self.model = init_pose_model(model_config, model_checkpoint,
                                     device=device)
        self.cls_ids = cls_ids
        self.cls_names = cls_names
        self.bbox_thr = bbox_thr
        self.track_info = {'next_id': 0, 'last_pose_preds': [],
                           'last_time': None}
        self.register_input_buffer(input_buffer, 'input', essential=True)
        self.register_output_buffer(output_buffer)

    def bypass(self, input_msgs):
        return input_msgs['input']

    def process(self, input_msgs: Dict[str, Message]) -> Message:
        input_msg = input_msgs['input']
        img = input_msg.get_image()
        det_results = input_msg.get_detection_results()
        if det_results is None:
            raise ValueError(
                f'{type(self).__name__} requires an upstream detector node '
                '(no detection results in the frame message)')

        det_preds = []
        for det_result in det_results:
            preds = det_result['preds']
            if self.cls_ids:
                preds = [p for p in preds if p['cls_id'] in self.cls_ids]
            elif self.cls_names:
                preds = [p for p in preds if p['label'] in self.cls_names]
            det_preds.extend(preds)

        from ..api.inference import inference_top_down_pose_model
        from ..api.tracking import get_track_id
        # Frames arrive BGR from cv2; the inference API takes RGB arrays.
        pose_preds, _ = inference_top_down_pose_model(
            self.model, img[:, :, ::-1], det_preds,
            bbox_thr=self.bbox_thr, format='xyxy')

        now = time.time()
        last_t = self.track_info['last_time']
        fps = 1.0 / (now - last_t) if last_t and last_t < now else None
        pose_preds, next_id = get_track_id(
            pose_preds, self.track_info['last_pose_preds'],
            self.track_info['next_id'], use_oks=False, tracking_thr=0.3,
            use_one_euro=True, fps=fps)
        self.track_info = {'next_id': next_id,
                           'last_pose_preds': [dict(p) for p in pose_preds],
                           'last_time': now}

        input_msg.add_pose_result(
            {'preds': pose_preds, 'dataset_info': self.model.dataset_info},
            tag=self.name)
        return input_msg
