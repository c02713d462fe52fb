"""Messages passed between webcam nodes.

Counterpart of the reference tools/webcam/webcam_apis/utils/message.py:
a Message carries structured data plus route information (which nodes it
passed through, with per-node info like fps), and FrameMessage adds the
frame image and tagged detection/pose results.
"""
from __future__ import annotations

import time
import uuid
from typing import Dict, List, Optional


class Message:
    """Base message: text + structured data + route info.

    Reference: utils/message.py:10 (Message).
    """

    def __init__(self, msg: str = '', data: Optional[Dict] = None):
        self.msg = msg
        self.data = data if data else {}
        self.route_info: List[Dict] = []
        self.timestamp = time.time()
        self.id = uuid.uuid4()

    def update_route_info(self, node=None, node_name: Optional[str] = None,
                          node_type: Optional[str] = None,
                          info: Optional[Dict] = None):
        """Append one node's entry to the route information."""
        if node is not None:
            node_name = node.name
            node_type = node.__class__.__name__
        self.route_info.append(
            {'node': node_name, 'node_type': node_type, 'info': info or {}})

    def set_route_info(self, route_info: List[Dict]):
        self.route_info = route_info

    def merge_route_info(self, route_info: List[Dict]):
        """Merge another message's route info (reference message.py:71),
        ordered by the per-entry timestamps when present."""
        self.route_info += route_info
        self.route_info.sort(
            key=lambda x: x.get('timestamp', float('inf')))

    def get_route_info(self) -> List[Dict]:
        return self.route_info.copy()


class VideoEndingMessage(Message):
    """Signals the input stream has ended (reference message.py:88)."""


class FrameMessage(Message):
    """A video frame plus tagged model results (reference message.py:92).

    data keys: 'image' (HxWx3 BGR), 'detection_results' / 'pose_results'
    (lists of (tag, result) tuples so multiple models can contribute).
    """

    def __init__(self, img):
        super().__init__(data=dict(image=img))

    def get_image(self):
        return self.data.get('image', None)

    def set_image(self, img):
        self.data['image'] = img

    def add_detection_result(self, result, tag: Optional[str] = None):
        self.data.setdefault('detection_results', []).append((tag, result))

    def get_detection_results(self, tag: Optional[str] = None):
        if 'detection_results' not in self.data:
            return None
        return [res for t, res in self.data['detection_results']
                if tag is None or t == tag]

    def add_pose_result(self, result, tag: Optional[str] = None):
        self.data.setdefault('pose_results', []).append((tag, result))

    def get_pose_results(self, tag: Optional[str] = None):
        if 'pose_results' not in self.data:
            return None
        return [res for t, res in self.data['pose_results']
                if tag is None or t == tag]

    def get_full_results(self) -> Dict:
        """All model predictions (reference message.py:176)."""
        return {k: self.data[k]
                for k in ('detection_results', 'pose_results')
                if k in self.data}

    def set_full_results(self, results: Dict):
        self.data.update(results)
