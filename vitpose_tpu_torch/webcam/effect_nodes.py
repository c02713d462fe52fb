"""Frame-drawing effect nodes.

Counterparts of the reference tools/webcam/webcam_apis/nodes/
frame_effect_node.py, faceswap_node.py, valentinemagic_node.py and
xdwendwen_node.py. The anchor geometry (keypoint-driven homography warps,
screen matting, seamless-clone face swaps) matches the reference; default
art assets are generated procedurally because this build targets
zero-egress deployments (the reference downloads them from GitHub CDN) —
every node accepts a path to load real artwork from disk instead.
"""
from __future__ import annotations

from enum import IntEnum
from typing import List, Optional, Tuple, Union

import numpy as np

from .message import FrameMessage
from .misc import (color_val, copy_and_paste, expand_and_clamp, load_image,
                   screen_matting)
from .node import NODES, FrameDrawingNode
from .pose_utils import (get_eye_keypoint_ids, get_face_keypoint_ids,
                         get_hand_keypoint_ids, get_mouth_keypoint_ids,
                         get_wrist_keypoint_ids)

# ---------------------------------------------------------------------------
# procedural default assets (BGR or BGRA uint8)
# ---------------------------------------------------------------------------


def make_sunglasses(size: int = 200) -> np.ndarray:
    """BGRA sunglasses sprite; lens centers at (0.28, 0.45) / (0.72, 0.45)
    of the canvas (the anchor contract used by SunglassesNode)."""
    import cv2
    w, h = size * 2, size
    img = np.zeros((h, w, 4), np.uint8)
    lw = int(0.20 * w)
    for cx in (int(0.28 * w), int(0.72 * w)):
        cv2.ellipse(img, (cx, int(0.45 * h)), (lw, int(0.32 * h)), 0, 0,
                    360, (30, 20, 20, 255), -1)
    cv2.line(img, (int(0.28 * w) + lw, int(0.40 * h)),
             (int(0.72 * w) - lw, int(0.40 * h)), (30, 20, 20, 255),
             max(2, h // 20))
    for x0, x1 in ((0, int(0.28 * w) - lw), (int(0.72 * w) + lw, w - 1)):
        cv2.line(img, (x0, int(0.35 * h)), (x1, int(0.42 * h)),
                 (30, 20, 20, 255), max(2, h // 24))
    return img


def make_moustache(size: int = 200) -> np.ndarray:
    """Moustache on a white background (masked by darkness, like the
    reference's white-background asset, frame_effect_node.py:584)."""
    import cv2
    w, h = size * 2, size
    img = np.full((h, w, 3), 255, np.uint8)
    for sign in (-1, 1):
        cx = w // 2 + sign * int(0.22 * w)
        cv2.ellipse(img, (cx, h // 2), (int(0.24 * w), int(0.18 * h)),
                    sign * 12, 0, 360, (40, 30, 30), -1)
    return img


def make_hat(size: int = 200) -> np.ndarray:
    """BGRA pointed party hat with a brim."""
    import cv2
    w, h = size, size
    img = np.zeros((h, w, 4), np.uint8)
    pts = np.array([[w // 2, int(0.05 * h)], [int(0.15 * w), int(0.8 * h)],
                    [int(0.85 * w), int(0.8 * h)]], np.int32)
    cv2.fillPoly(img, [pts], (40, 60, 200, 255))
    cv2.ellipse(img, (w // 2, int(0.8 * h)), (int(0.4 * w), int(0.1 * h)),
                0, 0, 360, (20, 140, 230, 255), -1)
    cv2.circle(img, (w // 2, int(0.07 * h)), max(3, w // 18),
               (60, 200, 250, 255), -1)
    return img


def make_heart(size: int = 128, color=(80, 60, 230)) -> np.ndarray:
    """BGRA heart sprite."""
    import cv2
    img = np.zeros((size, size, 4), np.uint8)
    r = size // 4
    col = tuple(color) + (255,)
    cv2.circle(img, (size // 2 - r + r // 4, size // 3), r, col, -1)
    cv2.circle(img, (size // 2 + r - r // 4, size // 3), r, col, -1)
    pts = np.array([[size // 2 - 2 * r + r // 4, int(size * 0.42)],
                    [size // 2 + 2 * r - r // 4, int(size * 0.42)],
                    [size // 2, int(size * 0.92)]], np.int32)
    cv2.fillPoly(img, [pts], col)
    return img


def make_firecracker_frames(n: int = 4, size: int = 160) -> List[np.ndarray]:
    """Animated firecracker on white background (reference uses a gif,
    frame_effect_node.py:801)."""
    import cv2
    frames = []
    w, h = size // 2, size
    for i in range(n):
        img = np.full((h, w, 3), 255, np.uint8)
        cv2.rectangle(img, (int(0.25 * w), int(0.3 * h)),
                      (int(0.75 * w), int(0.95 * h)), (40, 40, 200), -1)
        cv2.line(img, (w // 2, int(0.3 * h)), (w // 2, int(0.15 * h)),
                 (60, 100, 140), 3)
        rng = np.random.RandomState(i)
        for _ in range(8):
            ang = rng.uniform(0, 2 * np.pi)
            r = rng.uniform(0.05, 0.14) * h * (1 + i / n)
            x = int(w / 2 + r * np.cos(ang))
            y = int(0.15 * h + r * np.sin(ang))
            cv2.line(img, (w // 2, int(0.15 * h)), (x, y),
                     (0, 200, 255), 2)
        frames.append(img)
    return frames


def make_hair(size: int = 256) -> np.ndarray:
    """Spiky super-saiyan hair on black background (masked by brightness,
    reference frame_effect_node.py:491)."""
    import cv2
    w, h = size, size
    img = np.zeros((h, w, 3), np.uint8)
    rng = np.random.RandomState(0)
    base_y = int(0.95 * h)
    for k in range(12):
        x0 = int((0.1 + 0.8 * k / 11) * w)
        tip_x = x0 + int(rng.uniform(-0.08, 0.08) * w)
        tip_y = int(rng.uniform(0.05, 0.35) * h)
        pts = np.array([[x0 - w // 22, base_y], [x0 + w // 22, base_y],
                        [tip_x, tip_y]], np.int32)
        cv2.fillPoly(img, [pts], (60, 220, 250))
    return img


def make_sprite_sheet(cell: int = 36) -> np.ndarray:
    """[4 directions, 3 frames] BGRA walking-character sprites (the
    reference slices a Touhou sprite sheet, frame_effect_node.py:196)."""
    import cv2
    sheet = np.zeros((4, 3, cell, cell, 4), np.uint8)
    for d in range(4):
        for f in range(3):
            img = np.zeros((cell, cell, 4), np.uint8)
            cv2.circle(img, (cell // 2, cell // 3), cell // 5,
                       (180, 140, 255, 255), -1)
            sway = (f - 1) * cell // 10
            cv2.line(img, (cell // 2, cell // 3 + cell // 5),
                     (cell // 2, int(0.75 * cell)), (120, 200, 90, 255), 3)
            cv2.line(img, (cell // 2, int(0.75 * cell)),
                     (cell // 2 - cell // 6 + sway, cell - 2),
                     (120, 200, 90, 255), 3)
            cv2.line(img, (cell // 2, int(0.75 * cell)),
                     (cell // 2 + cell // 6 - sway, cell - 2),
                     (120, 200, 90, 255), 3)
            dx = [0, -1, 1, 0][d] * cell // 8
            cv2.circle(img, (cell // 2 + dx, cell // 3 - cell // 12), 2,
                       (0, 0, 0, 255), -1)
            sheet[d, f] = img
    return sheet


# ---------------------------------------------------------------------------
# shared compositing
# ---------------------------------------------------------------------------


def _load_asset(path: Optional[str], fallback, flags=None):
    if path is None:
        return fallback()
    import cv2
    return load_image(path, flags if flags is not None
                      else cv2.IMREAD_UNCHANGED)


def warp_and_paste(img, src, pts_src, pts_tar, mask_mode: str = 'auto',
                   thr: int = 240):
    """Homography-warp `src` so pts_src land on pts_tar, then composite
    onto `img` — the core of every reference sticker effect
    (frame_effect_node.py:575-607 and mmpose.core apply_*_effect)."""
    import cv2
    h_mat, _ = cv2.findHomography(np.asarray(pts_src, np.float32),
                                  np.asarray(pts_tar, np.float32))
    if h_mat is None:
        return img
    has_alpha = src.ndim == 3 and src.shape[2] == 4
    border = (0, 0, 0, 0) if has_alpha else (
        (255, 255, 255) if mask_mode == 'light_bg' else (0, 0, 0))
    patch = cv2.warpPerspective(src, h_mat,
                                dsize=(img.shape[1], img.shape[0]),
                                borderValue=border)
    if has_alpha:
        mask = patch[:, :, 3] > 128
        patch = patch[:, :, :3]
    elif mask_mode == 'light_bg':
        # white-background art: keep non-white pixels
        mask = cv2.cvtColor(patch, cv2.COLOR_BGR2GRAY) < thr
    else:
        # dark-background art: keep bright pixels
        mask = cv2.cvtColor(patch, cv2.COLOR_BGR2GRAY) > 10
    return cv2.copyTo(patch, mask.astype(np.uint8), img)


def _alpha_paste(img, sprite, center_xy, width: float):
    """Scale an BGRA sprite to `width` px and alpha-blend at center."""
    import cv2
    if width < 4:
        return img
    s = width / sprite.shape[1]
    sp = cv2.resize(sprite, None, fx=s, fy=s)
    sh, sw = sp.shape[:2]
    x0 = int(center_xy[0] - sw / 2)
    y0 = int(center_xy[1] - sh / 2)
    x1, y1 = max(0, x0), max(0, y0)
    x2, y2 = min(img.shape[1], x0 + sw), min(img.shape[0], y0 + sh)
    if x2 - x1 < 2 or y2 - y1 < 2:
        return img
    crop = sp[y1 - y0:y2 - y0, x1 - x0:x2 - x0]
    alpha = crop[:, :, 3:4].astype(np.float32) / 255.0
    img[y1:y2, x1:x2] = (img[y1:y2, x1:x2] * (1 - alpha)
                         + crop[:, :, :3] * alpha).astype(np.uint8)
    return img


def _eye_anchors(kpts, le_idx, re_idx, kpt_thr):
    """(leye, reye, orthogonal) anchor frame used by several effects
    (reference frame_effect_node.py:478,745)."""
    le, re = kpts[le_idx], kpts[re_idx]
    if le[2] < kpt_thr or re[2] < kpt_thr:
        return None
    vo = (re[:2] - le[:2])[::-1] * np.array([-1.0, 1.0])
    return le[:2], re[:2], vo


# ---------------------------------------------------------------------------
# effect nodes
# ---------------------------------------------------------------------------


@NODES.register_module()
class PoseVisualizerNode(FrameDrawingNode):
    """Draw bboxes + keypoints/skeleton (reference frame_effect_node.py:26).
    """

    default_bbox_color = {'person': (148, 139, 255), 'cat': (255, 255, 0),
                          'dog': (255, 255, 0)}

    def __init__(self, name: str, frame_buffer: str,
                 output_buffer: Union[str, List[str]],
                 enable_key=None, enable: bool = True,
                 kpt_thr: float = 0.3, radius: int = 4, thickness: int = 2,
                 bbox_color=None):
        super().__init__(name, frame_buffer, output_buffer, enable_key,
                         enable)
        self.kpt_thr = kpt_thr
        self.radius = radius
        self.thickness = thickness
        if bbox_color is None:
            self.bbox_color = self.default_bbox_color
        elif isinstance(bbox_color, dict):
            self.bbox_color = {k: color_val(v)
                               for k, v in bbox_color.items()}
        else:
            self.bbox_color = color_val(bbox_color)

    def draw(self, frame_msg: FrameMessage):
        import cv2
        canvas = frame_msg.get_image()
        pose_results = frame_msg.get_pose_results()
        if not pose_results:
            return canvas
        for pose_result in pose_results:
            info = pose_result['dataset_info']
            links = info.skeleton_links
            kp_colors = info.keypoint_colors
            sk_colors = info.skeleton_colors
            for pred in pose_result['preds']:
                bbox = pred.get('bbox')
                if bbox is not None:
                    color = (self.bbox_color.get(pred.get('label'),
                                                 (0, 255, 0))
                             if isinstance(self.bbox_color, dict)
                             else self.bbox_color)
                    x1, y1, x2, y2 = (int(v) for v in bbox[:4])
                    cv2.rectangle(canvas, (x1, y1), (x2, y2), color, 1)
                kpts = np.asarray(pred['keypoints'])
                for j, (x, y, s) in enumerate(kpts):
                    if s < self.kpt_thr:
                        continue
                    c = tuple(int(v) for v in (kp_colors[j]
                                               if len(kp_colors)
                                               else (0, 255, 0)))
                    cv2.circle(canvas, (int(x), int(y)), self.radius, c, -1)
                for li, (a, b) in enumerate(links):
                    if kpts[a, 2] < self.kpt_thr or kpts[b, 2] < self.kpt_thr:
                        continue
                    c = tuple(int(v) for v in (sk_colors[li]
                                               if len(sk_colors)
                                               else (255, 128, 0)))
                    cv2.line(canvas, tuple(kpts[a, :2].astype(int)),
                             tuple(kpts[b, :2].astype(int)), c,
                             self.thickness)
        return canvas


@NODES.register_module()
class SunglassesNode(FrameDrawingNode):
    """Sunglasses anchored on the eye pair (reference
    frame_effect_node.py:139 + mmpose.core apply_sunglasses_effect)."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, enable: bool = True,
                 src_img_path: Optional[str] = None, kpt_thr: float = 0.5):
        super().__init__(name, frame_buffer, output_buffer, enable_key,
                         enable)
        self.src_img = _load_asset(src_img_path, make_sunglasses)
        self.kpt_thr = kpt_thr
        h, w = self.src_img.shape[:2]
        # lens centers + one orthogonal step below them
        self.pts_src = np.array([[0.28 * w, 0.45 * h], [0.72 * w, 0.45 * h],
                                 [0.28 * w, 0.95 * h], [0.72 * w, 0.95 * h]],
                                np.float32)

    def draw(self, frame_msg):
        canvas = frame_msg.get_image()
        for pose_result in frame_msg.get_pose_results() or []:
            le_idx, re_idx = get_eye_keypoint_ids(
                pose_result['dataset_info'])
            for pred in pose_result['preds']:
                anch = _eye_anchors(np.asarray(pred['keypoints']), le_idx,
                                    re_idx, self.kpt_thr)
                if anch is None:
                    continue
                le, re, vo = anch
                pts_tar = np.vstack([le, re, le + 0.6 * vo, re + 0.6 * vo])
                canvas = warp_and_paste(canvas, self.src_img, self.pts_src,
                                        pts_tar)
        return canvas


@NODES.register_module()
class BugEyeNode(FrameDrawingNode):
    """Fisheye magnification of the eye regions (reference
    frame_effect_node.py:612 + mmpose.core apply_bugeye_effect)."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, enable: bool = True,
                 kpt_thr: float = 0.5):
        super().__init__(name, frame_buffer, output_buffer, enable_key,
                         enable)
        self.kpt_thr = kpt_thr

    @staticmethod
    def _magnify(img, center, radius: int, strength: float = 1.8):
        import cv2
        x0 = int(max(0, center[0] - radius))
        y0 = int(max(0, center[1] - radius))
        x1 = int(min(img.shape[1], center[0] + radius))
        y1 = int(min(img.shape[0], center[1] + radius))
        if x1 - x0 < 4 or y1 - y0 < 4:
            return img
        patch = img[y0:y1, x0:x1]
        ph, pw = patch.shape[:2]
        ys, xs = np.mgrid[0:ph, 0:pw].astype(np.float32)
        cx, cy = center[0] - x0, center[1] - y0
        dx, dy = xs - cx, ys - cy
        r = np.sqrt(dx * dx + dy * dy)
        rn = np.minimum(r / max(radius, 1), 1.0)
        # magnified center: sample closer to the center than the output
        factor = rn ** (strength - 1.0)
        map_x = (cx + dx * factor).astype(np.float32)
        map_y = (cy + dy * factor).astype(np.float32)
        img[y0:y1, x0:x1] = cv2.remap(patch, map_x, map_y,
                                      cv2.INTER_LINEAR,
                                      borderMode=cv2.BORDER_REPLICATE)
        return img

    def draw(self, frame_msg):
        canvas = frame_msg.get_image()
        for pose_result in frame_msg.get_pose_results() or []:
            le_idx, re_idx = get_eye_keypoint_ids(
                pose_result['dataset_info'])
            for pred in pose_result['preds']:
                kpts = np.asarray(pred['keypoints'])
                anch = _eye_anchors(kpts, le_idx, re_idx, self.kpt_thr)
                if anch is None:
                    continue
                le, re, _ = anch
                radius = max(int(0.6 * np.linalg.norm(re - le)), 8)
                for eye in (le, re):
                    canvas = self._magnify(canvas, eye, radius)
        return canvas


@NODES.register_module()
class MoustacheNode(FrameDrawingNode):
    """Moustache under the nose (reference frame_effect_node.py:526):
    anchored on face contour points 32/34/61/63 when 68-point face
    keypoints are available, else on an eyes/nose frame (COCO)."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, enable: bool = True,
                 src_img_path: Optional[str] = None, kpt_thr: float = 0.5):
        super().__init__(name, frame_buffer, output_buffer, enable_key,
                         enable)
        self.src_img = _load_asset(src_img_path, make_moustache)
        self.kpt_thr = kpt_thr
        h, w = self.src_img.shape[:2]
        self.pts_src = np.array([[0.15 * w, 0.3 * h], [0.85 * w, 0.3 * h],
                                 [0.15 * w, 0.9 * h], [0.85 * w, 0.9 * h]],
                                np.float32)

    def draw(self, frame_msg):
        canvas = frame_msg.get_image()
        for pose_result in frame_msg.get_pose_results() or []:
            info = pose_result['dataset_info']
            try:
                face = get_face_keypoint_ids(info)
            except ValueError:
                face = None
            for pred in pose_result['preds']:
                kpts = np.asarray(pred['keypoints'])
                if face is not None:
                    ids = [face[32], face[34], face[61], face[63]]
                    if any(kpts[i, 2] < self.kpt_thr for i in ids):
                        continue
                    pts_tar = kpts[ids][:, :2]
                else:
                    le_idx, re_idx = get_eye_keypoint_ids(info)
                    nose = kpts[0]
                    anch = _eye_anchors(kpts, le_idx, re_idx, self.kpt_thr)
                    if anch is None or nose[2] < self.kpt_thr:
                        continue
                    le, re, vo = anch
                    veye = 0.35 * (re - le)
                    von = vo / (np.linalg.norm(vo) + 1e-6)
                    base = nose[:2] + von * 0.35 * np.linalg.norm(re - le)
                    pts_tar = np.vstack([
                        base - veye, base + veye,
                        base - veye + 0.8 * vo * 0.35,
                        base + veye + 0.8 * vo * 0.35])
                canvas = warp_and_paste(canvas, self.src_img, self.pts_src,
                                        pts_tar, mask_mode='light_bg',
                                        thr=200)
        return canvas


@NODES.register_module()
class HatNode(FrameDrawingNode):
    """Hat above the eyes (reference frame_effect_node.py:694)."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, enable: bool = True,
                 src_img_path: Optional[str] = None, kpt_thr: float = 0.5):
        super().__init__(name, frame_buffer, output_buffer, enable_key,
                         enable)
        self.src_img = _load_asset(src_img_path, make_hat)
        self.kpt_thr = kpt_thr
        h, w = self.src_img.shape[:2]
        a, b = 0.3, 0.7
        self.pts_src = np.array([[a * w, a * h], [a * w, b * h],
                                 [b * w, a * h], [b * w, b * h]], np.float32)

    def draw(self, frame_msg):
        canvas = frame_msg.get_image()
        for pose_result in frame_msg.get_pose_results() or []:
            le_idx, re_idx = get_eye_keypoint_ids(
                pose_result['dataset_info'])
            for pred in pose_result['preds']:
                anch = _eye_anchors(np.asarray(pred['keypoints']), le_idx,
                                    re_idx, self.kpt_thr)
                if anch is None:
                    continue
                le, re, vo = anch
                veye = 0.5 * (re - le)
                vo = 0.5 * vo
                # reference anchor frame (frame_effect_node.py:747-752)
                pts_tar = np.vstack([re + veye + 5 * vo, re + veye + vo,
                                     le - veye + 5 * vo, le - veye + vo])
                canvas = warp_and_paste(canvas, self.src_img, self.pts_src,
                                        pts_tar)
        return canvas


@NODES.register_module()
class FirecrackerNode(FrameDrawingNode):
    """Animated firecracker at the wrists (reference
    frame_effect_node.py:793)."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, src_img_path: Optional[str] = None,
                 kpt_thr: float = 0.5):
        super().__init__(name, frame_buffer, output_buffer, enable_key)
        if src_img_path is not None:
            import cv2
            cap = cv2.VideoCapture(src_img_path)
            self.frame_list = []
            ok, frame = cap.read()
            while frame is not None:
                self.frame_list.append(frame)
                ok, frame = cap.read()
        else:
            self.frame_list = make_firecracker_frames()
        self.num_frames = len(self.frame_list)
        self.frame_idx = 0
        self.frame_period = 4
        self.kpt_thr = kpt_thr

    def draw(self, frame_msg):
        canvas = frame_msg.get_image()
        pose_results = frame_msg.get_pose_results()
        if not pose_results:
            return canvas
        src = self.frame_list[self.frame_idx // self.frame_period]
        hm, wm = src.shape[:2]
        pts_src = np.array([[0, 0], [0, hm], [wm, 0], [wm, hm]], np.float32)
        h_tar = canvas.shape[0] / 3
        w_tar = h_tar / hm * wm
        for pose_result in pose_results:
            lw_idx, rw_idx = get_wrist_keypoint_ids(
                pose_result['dataset_info'])
            for pred in pose_result['preds']:
                kpts = np.asarray(pred['keypoints'])
                for idx in (lw_idx, rw_idx):
                    if kpts[idx, 2] < self.kpt_thr:
                        continue
                    wr = kpts[idx, :2]
                    pts_tar = np.vstack([wr - [w_tar / 2, 0],
                                         wr - [w_tar / 2, -h_tar],
                                         wr + [w_tar / 2, 0],
                                         wr + [w_tar / 2, h_tar]])
                    canvas = warp_and_paste(canvas, src, pts_src, pts_tar,
                                            mask_mode='light_bg')
        self.frame_idx = (self.frame_idx + 1) % (self.num_frames
                                                 * self.frame_period)
        return canvas


@NODES.register_module()
class NoticeBoardNode(FrameDrawingNode):
    """Semi-transparent text board (reference frame_effect_node.py:630)."""

    default_content_lines = ['This is a notice board!']

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, enable: bool = True,
                 content_lines: Optional[List[str]] = None,
                 x_offset: int = 20, y_offset: int = 20, y_delta: int = 15,
                 text_color='black', background_color=(255, 183, 0),
                 text_scale: float = 0.4):
        super().__init__(name, frame_buffer, output_buffer, enable_key,
                         enable)
        self.x_offset, self.y_offset = x_offset, y_offset
        self.y_delta = y_delta
        self.text_color = color_val(text_color)
        self.background_color = color_val(background_color)
        self.text_scale = text_scale
        self.content_lines = content_lines or self.default_content_lines

    def draw(self, frame_msg):
        import cv2
        img = frame_msg.get_image()
        canvas = np.full(img.shape, self.background_color, dtype=img.dtype)
        x, y = self.x_offset, self.y_offset
        for line in self.content_lines:
            cv2.putText(canvas, line, (x, y), cv2.FONT_HERSHEY_DUPLEX,
                        self.text_scale, self.text_color, 1)
            y += self.y_delta
        max_len = max(len(line) for line in self.content_lines)
        x1, y1 = max(0, x), max(0, self.y_offset - self.y_delta)
        x2 = min(img.shape[1], int(x + max_len * self.text_scale * 20))
        y2 = min(img.shape[0], y)
        img[y1:y2, x1:x2] = cv2.addWeighted(canvas[y1:y2, x1:x2], 0.5,
                                            img[y1:y2, x1:x2], 0.5, 0)
        return img


@NODES.register_module()
class BackgroundNode(FrameDrawingNode):
    """Replace the background, keeping the detected instances (reference
    frame_effect_node.py:299). Uses instance masks when the detector
    provides them, else the detection boxes."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, enable: bool = True,
                 src_img_path: Optional[str] = None,
                 cls_ids: Optional[List[int]] = None,
                 cls_names: Optional[List[str]] = None):
        super().__init__(name, frame_buffer, output_buffer, enable_key,
                         enable)
        self.cls_ids, self.cls_names = cls_ids, cls_names
        if src_img_path is not None:
            import cv2
            self.src_img = load_image(src_img_path, cv2.IMREAD_COLOR)
        else:
            # procedural sky-gradient background
            grad = np.linspace(255, 80, 480, dtype=np.uint8)
            self.src_img = np.stack([np.tile(grad[:, None], (1, 640)),
                                     np.full((480, 640), 170, np.uint8),
                                     np.full((480, 640), 120, np.uint8)],
                                    axis=-1)

    def draw(self, frame_msg):
        import cv2
        canvas = frame_msg.get_image()
        if canvas.shape != self.src_img.shape:
            self.src_img = cv2.resize(self.src_img,
                                      (canvas.shape[1], canvas.shape[0]))
        det_results = frame_msg.get_detection_results()
        if not det_results:
            return canvas
        preds = []
        for det_result in det_results:
            ps = det_result['preds']
            if self.cls_ids:
                ps = [p for p in ps if p['cls_id'] in self.cls_ids]
            elif self.cls_names:
                ps = [p for p in ps if p['label'] in self.cls_names]
            preds.extend(ps)
        if not preds:
            return self.src_img.copy()
        det = preds[0]
        mask = det.get('mask')
        if mask is None:
            mask = np.zeros(canvas.shape[:2], np.uint8)
            x1, y1, x2, y2 = (int(v) for v in det['bbox'][:4])
            mask[max(0, y1):y2, max(0, x1):x2] = 1
        return copy_and_paste(canvas, self.src_img, mask.astype(np.uint8),
                              det['bbox'][:4])


@NODES.register_module()
class SaiyanNode(FrameDrawingNode):
    """Super-saiyan hair + optional green-screen aura video (reference
    frame_effect_node.py:384). Hair is anchored on the face contour edges
    (wholebody face kpts 0/16) or, for COCO, an eye-based frame."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, enable: bool = True,
                 hair_img_path: Optional[str] = None,
                 light_video_path: Optional[str] = None,
                 kpt_thr: float = 0.5, bbox_thr: float = 0.3):
        import cv2
        super().__init__(name, frame_buffer, output_buffer, enable_key,
                         enable)
        self.hair_img = _load_asset(hair_img_path, make_hair,
                                    flags=cv2.IMREAD_COLOR)
        self.light_video_path = light_video_path
        self.light_video = (cv2.VideoCapture(light_video_path)
                            if light_video_path else None)
        self.kpt_thr = kpt_thr
        self.bbox_thr = bbox_thr

    def _light_frame(self):
        import cv2
        if self.light_video is None:
            return None
        ok, frame = self.light_video.read()
        if not ok:
            self.light_video = cv2.VideoCapture(self.light_video_path)
            ok, frame = self.light_video.read()
        return frame if ok else None

    def draw(self, frame_msg):
        canvas = frame_msg.get_image()
        hh, hw = self.hair_img.shape[:2]
        pts_src = np.array([[0.1 * hw, 0.95 * hh], [0.9 * hw, 0.95 * hh],
                            [0.1 * hw, 0.1 * hh], [0.9 * hw, 0.1 * hh]],
                           np.float32)
        for pose_result in frame_msg.get_pose_results() or []:
            info = pose_result['dataset_info']
            try:
                face = get_face_keypoint_ids(info)
            except ValueError:
                face = None
            for pred in pose_result['preds']:
                kpts = np.asarray(pred['keypoints'])
                bbox = pred.get('bbox')

                light = self._light_frame()
                if light is not None and bbox is not None \
                        and bbox[-1] >= self.bbox_thr:
                    light_mask = screen_matting(light, color='green')
                    region = expand_and_clamp(bbox[:4], canvas.shape, s=3.0)
                    h, w = canvas.shape[:2]
                    canvas = copy_and_paste(
                        light, canvas, light_mask,
                        effect_region=(region[0] / w, region[1] / h,
                                       region[2] / w, region[3] / h))

                if face is not None:
                    a, b = kpts[face[0]], kpts[face[16]]
                    if a[2] < self.kpt_thr or b[2] < self.kpt_thr:
                        continue
                    k0, k16 = a[:2], b[:2]
                else:
                    le_idx, re_idx = get_eye_keypoint_ids(info)
                    anch = _eye_anchors(kpts, le_idx, re_idx, self.kpt_thr)
                    if anch is None:
                        continue
                    le, re, _ = anch
                    widen = 1.1 * (re - le)
                    k0, k16 = le - widen, re + widen
                vo = (k0 - k16)[::-1] * np.array([-1.0, 1.0])
                pts_tar = np.vstack([k0, k16, k0 + vo, k16 + vo])
                canvas = warp_and_paste(canvas, self.hair_img, pts_src,
                                        pts_tar, mask_mode='dark_bg')
        return canvas


@NODES.register_module()
class SpriteNode(FrameDrawingNode):
    """Animated sprite that walks toward the nearest target keypoint
    (reference frame_effect_node.py:174)."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, enable: bool = True,
                 src_img_path: Optional[str] = None, kpt_thr: float = 0.5):
        super().__init__(name, frame_buffer, output_buffer, enable_key,
                         enable)
        if src_img_path is not None:
            import cv2
            sheet = load_image(src_img_path, cv2.IMREAD_UNCHANGED)[:144,
                                                                   :108]
            tmp = np.array(np.split(sheet, range(36, 144, 36), axis=0))
            self.sprites = np.array(np.split(tmp, range(36, 108, 36),
                                             axis=2)).transpose(1, 0, 2, 3,
                                                                4)
        else:
            self.sprites = make_sprite_sheet()
        self.pos = None          # (row, col) like the reference
        self.anime_frame = 0
        self.kpt_thr = kpt_thr

    def draw(self, frame_msg):
        img = frame_msg.get_image()
        if self.pos is None:
            self.pos = [img.shape[0] // 2, img.shape[1] // 2]
        pose_results = frame_msg.get_pose_results()
        if not pose_results:
            return img
        preds = [p for r in pose_results for p in r['preds']]
        if not preds:
            return img
        info = pose_results[0]['dataset_info']
        le_idx, re_idx = get_eye_keypoint_ids(info)
        kpts = np.asarray(preds[0]['keypoints'])
        aim = self.pos
        if kpts[le_idx, 2] >= self.kpt_thr or kpts[re_idx, 2] >= self.kpt_thr:
            cand = [kpts[i, :2][::-1] for i in (le_idx, re_idx)
                    if kpts[i, 2] >= self.kpt_thr]
            dists = [np.sum((np.asarray(c) - self.pos) ** 2) for c in cand]
            aim = cand[int(np.argmin(dists))]

        thr = 15
        direction = 0
        if aim[0] < self.pos[0] - thr:
            direction, self.pos[0] = 3, self.pos[0] - 1
        elif aim[0] > self.pos[0] + thr:
            direction, self.pos[0] = 0, self.pos[0] + 1
        elif aim[1] < self.pos[1] - thr:
            direction, self.pos[1] = 1, self.pos[1] - 1
        elif aim[1] > self.pos[1] + thr:
            direction, self.pos[1] = 2, self.pos[1] + 1
        else:
            self.anime_frame = 0
        sprite = self.sprites[direction][self.anime_frame]
        self.anime_frame = (self.anime_frame + 1) % self.sprites.shape[1]

        return _alpha_paste(img, sprite, (self.pos[1], self.pos[0]),
                            sprite.shape[1])


class FaceSwapMode(IntEnum):
    """reference faceswap_node.py:13"""
    NONE = 0
    SHUFFLE = 1
    CLONE = 2


@NODES.register_module()
class FaceSwapNode(FrameDrawingNode):
    """Swap faces among the detected people (reference faceswap_node.py:20):
    SHUFFLE permutes faces, CLONE copies one face onto everyone; the
    mode_key hot-key cycles NONE -> SHUFFLE -> CLONE."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 mode_key: Union[str, int]):
        super().__init__(name, frame_buffer, output_buffer, enable=True)
        self.mode_key = mode_key
        self.register_event(self.mode_key, is_keyboard=True,
                            handler_func=self.switch_mode)
        self._mode = FaceSwapMode.SHUFFLE
        self.history = {'mode': None}
        self._rng = np.random.RandomState(0)

    @property
    def mode(self):
        return self._mode

    def switch_mode(self):
        self._mode = FaceSwapMode((self._mode + 1) % len(FaceSwapMode))

    def draw(self, frame_msg):
        import cv2
        if self.mode == FaceSwapMode.NONE:
            self.history = {'mode': FaceSwapMode.NONE}
            return frame_msg.get_image()
        if self.history['mode'] != self.mode:
            self.history = {'mode': self.mode, 'target_map': {}}

        preds = self._merge_pose_results(frame_msg.get_pose_results())
        img = frame_msg.get_image()
        canvas = img.copy()
        cv2.putText(canvas,
                    'Shuffle' if self.mode == FaceSwapMode.SHUFFLE
                    else 'Clone', (10, 50), cv2.FONT_HERSHEY_DUPLEX, 0.8,
                    (255, 126, 0), 1)
        n = len(preds)
        if n >= 2:
            if n != len(self.history['target_map']):
                if self.mode == FaceSwapMode.SHUFFLE:
                    ids = self._rng.choice(n, n, replace=False)
                    self.history['target_map'] = ids[(ids + 1) % n]
                else:
                    self.history['target_map'] = np.repeat(
                        self._rng.choice(n), n)
            for tar_idx, src_idx in enumerate(self.history['target_map']):
                canvas = self._swap_face(img, canvas,
                                         self._face_info(preds[src_idx]),
                                         self._face_info(preds[tar_idx]))
        return canvas

    @staticmethod
    def _merge_pose_results(pose_results):
        preds = []
        for result in pose_results or []:
            for pred in result['preds']:
                p = dict(pred)
                p['dataset_info'] = result['dataset_info']
                preds.append(p)
        return preds

    @staticmethod
    def _face_info(pred):
        """Landmarks (eyes/nose/chin-proxy) + face contour (reference
        faceswap_node.py:152): wholebody uses the annotated contour;
        COCO-style gets a constructed quad from the eye/nose frame."""
        kpts = np.asarray(pred['keypoints'])[:, :2]
        info = pred['dataset_info']
        names = {n: i for i, n in enumerate(info.keypoint_names)}
        contour = None
        if 'face_0' in names:
            face = [names[f'face_{i}'] for i in range(68)]
            landmarks = np.stack([kpts[names['left_eye']],
                                  kpts[names['right_eye']],
                                  kpts[names['nose']],
                                  kpts[face[8]]])
            contour_ids = face[:17] + face[17:27][::-1]
            contour = kpts[contour_ids]
        else:
            le, re = get_eye_keypoint_ids(info)
            nose = names.get('nose', 0)
            if 'left_shoulder' in names:
                chin = 0.5 * (kpts[names['left_shoulder']]
                              + kpts[names['right_shoulder']])
            else:
                chin = kpts[nose] + (kpts[nose] - 0.5 * (kpts[le]
                                                         + kpts[re])) * 2
            landmarks = np.stack([kpts[le], kpts[re], kpts[nose], chin])
        if contour is None:
            left_eye, right_eye, nose = landmarks[:3]
            eye_center = 0.5 * (left_eye + right_eye)
            w_vec = right_eye - left_eye
            eye_dist = np.linalg.norm(w_vec) + 1e-6
            w_vec = w_vec / eye_dist
            h_vec = np.array([w_vec[1], -w_vec[0]])
            w = max(0.5 * eye_dist,
                    abs(np.dot(nose - eye_center, w_vec)))
            h = abs(np.dot(nose - eye_center, h_vec))
            contour = np.stack([
                eye_center + 1.5 * w * w_vec - 0.5 * h * h_vec,
                eye_center - 1.5 * w * w_vec - 0.5 * h * h_vec,
                eye_center - 1.5 * w * w_vec + 4 * h * h_vec,
                eye_center + 1.5 * w * w_vec + 4 * h * h_vec])
        return {'landmarks': landmarks, 'contour': contour,
                'dataset': info.dataset_name}

    @staticmethod
    def _crop_by_contour(img, contour):
        import cv2
        mask = np.zeros(img.shape[:2], np.uint8)
        cv2.fillPoly(mask, [contour.astype(np.int32)], 1)
        mask = cv2.dilate(mask, np.ones((9, 9), np.uint8))
        x, y, w, h = cv2.boundingRect(mask)
        bbox = np.array([x, y, x + w, y + h], np.int64)
        return bbox, img[y:y + h, x:x + w], mask[y:y + h, x:x + w]

    def _swap_face(self, img_src, img_tar, face_src, face_tar):
        import cv2
        kpts_src = (face_src['contour']
                    if face_src['dataset'] == face_tar['dataset']
                    else face_src['landmarks'])
        kpts_tar = (face_tar['contour']
                    if face_src['dataset'] == face_tar['dataset']
                    else face_tar['landmarks'])
        bbox_src, patch_src, mask_src = self._crop_by_contour(
            img_src, face_src['contour'])
        bbox_tar, _, mask_tar = self._crop_by_contour(
            img_tar, face_tar['contour'])
        if min(bbox_tar[2:] - bbox_tar[:2]) < 4 \
                or min(bbox_src[2:] - bbox_src[:2]) < 4:
            return img_tar
        kpts_src = kpts_src - bbox_src[:2]
        kpts_tar = kpts_tar - bbox_tar[:2]
        trans, _ = cv2.estimateAffine2D(kpts_src.astype(np.float32),
                                        kpts_tar.astype(np.float32))
        if trans is None:
            return img_tar
        dsize = tuple(int(v) for v in (bbox_tar[2:] - bbox_tar[:2]))
        patch = cv2.warpAffine(patch_src, trans, dsize)
        mask_warp = cv2.warpAffine(mask_src, trans, dsize)
        mask = (mask_tar & mask_warp)
        if mask.sum() < 16:
            return img_tar
        soft = cv2.GaussianBlur(mask * 255, (3, 3), 3)
        center = tuple(int(v) for v in
                       0.5 * (bbox_tar[:2] + bbox_tar[2:]))
        try:
            return cv2.seamlessClone(patch, img_tar, soft, center,
                                     cv2.NORMAL_CLONE)
        except cv2.error:
            # near-border faces: plain masked paste fallback
            out = img_tar.copy()
            region = out[bbox_tar[1]:bbox_tar[3], bbox_tar[0]:bbox_tar[2]]
            region[mask > 0] = patch[mask > 0]
            return out


@NODES.register_module()
class ValentineMagicNode(FrameDrawingNode):
    """Draw a growing heart between two people making a hand-heart or
    blow-kiss gesture (reference valentinemagic_node.py:25). With wholebody
    hand keypoints, gestures follow the reference's pinky-angle test; for
    body-only models a near-touching-wrists test is used."""

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 enable_key=None, kpt_vis_thr: float = 0.3,
                 hand_heart_angle_thr: float = 90.0,
                 longest_duration: float = 2.0,
                 largest_ratio: float = 0.25,
                 hand_heart_img_path: Optional[str] = None,
                 flying_heart_img_path: Optional[str] = None,
                 num_persons: int = 2):
        super().__init__(name, frame_buffer, output_buffer,
                         enable_key=enable_key)
        self.hand_heart = _load_asset(hand_heart_img_path, make_heart)
        self.flying_heart = _load_asset(
            flying_heart_img_path,
            lambda: make_heart(color=(180, 105, 255)))
        self.kpt_vis_thr = kpt_vis_thr
        self.hand_heart_angle_thr = hand_heart_angle_thr
        self.longest_duration = longest_duration
        self.largest_ratio = largest_ratio
        self.num_persons = num_persons
        self.heart_infos = {}   # track_id -> (start_frame, kind)
        self._frame = 0

    @staticmethod
    def _angle(p1, p2, p3, p4):
        v1, v2 = p2 - p1, p4 - p3
        cos = (v1 @ v2) / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-6)
        return np.degrees(np.arccos(np.clip(cos, -1, 1)))

    def _check_heart(self, kpts, hand_ids) -> int:
        """0 none / 1 hand-heart (reference valentinemagic_node.py:87)."""
        pinky = [0, 17, 19, 20, 21, 38, 40, 41]
        if any(kpts[hand_ids[i], 2] < self.kpt_vis_thr for i in pinky):
            return 0
        la = self._angle(kpts[hand_ids[20], :2], kpts[hand_ids[19], :2],
                         kpts[hand_ids[17], :2], kpts[hand_ids[0], :2])
        ra = self._angle(kpts[hand_ids[41], :2], kpts[hand_ids[40], :2],
                         kpts[hand_ids[38], :2], kpts[hand_ids[21], :2])
        tips = np.linalg.norm(kpts[hand_ids[20], :2]
                              - kpts[hand_ids[41], :2])
        eye = np.linalg.norm(kpts[1, :2] - kpts[2, :2]) + 1e-6
        if la < self.hand_heart_angle_thr and ra < self.hand_heart_angle_thr \
                and tips < eye:
            return 1
        return 0

    def _check_wrists(self, kpts, lw, rw) -> int:
        """Body-only fallback: both wrists together above the nose."""
        if kpts[lw, 2] < self.kpt_vis_thr or kpts[rw, 2] < self.kpt_vis_thr:
            return 0
        d = np.linalg.norm(kpts[lw, :2] - kpts[rw, :2])
        shoulder = np.linalg.norm(kpts[5, :2] - kpts[6, :2]) + 1e-6
        if d < 0.5 * shoulder and kpts[lw, 1] < kpts[0, 1]:
            return 1
        return 0

    def draw(self, frame_msg):
        img = frame_msg.get_image()
        self._frame += 1
        pose_results = frame_msg.get_pose_results()
        if not pose_results:
            return img
        preds = [p for r in pose_results
                 for p in r['preds']][:self.num_persons]
        info = pose_results[0]['dataset_info']
        try:
            hand_ids = get_hand_keypoint_ids(info)
        except ValueError:
            hand_ids = None
        try:
            mouth_id = get_mouth_keypoint_ids(info)
        except ValueError:
            mouth_id = 0   # nose as mouth proxy
        lw, rw = get_wrist_keypoint_ids(info)

        fps = 30.0
        max_frames = self.longest_duration * fps
        for pred in preds:
            kpts = np.asarray(pred['keypoints'])
            tid = pred.get('track_id', id(pred) % 997)
            kind = (self._check_heart(kpts, hand_ids) if hand_ids
                    else self._check_wrists(kpts, lw, rw))
            if kind == 0:
                self.heart_infos.pop(tid, None)
                continue
            start = self.heart_infos.setdefault(tid, self._frame)
            progress = min((self._frame - start) / max_frames, 1.0)
            width = img.shape[1] * self.largest_ratio * (0.2
                                                         + 0.8 * progress)
            anchor = kpts[mouth_id, :2] - [0, width * 0.7]
            img = _alpha_paste(img, self.hand_heart, anchor, width)
        return img


@NODES.register_module()
class XDwenDwenNode(FrameDrawingNode):
    """Blend the captured face into a mascot template with a bounce
    animation (reference xdwendwen_node.py:23). The reference loads
    labelbee-annotated template images; here templates are
    {'image'|'image_path', 'keypoints' [3,2], 'mask_polygon' [N,2]} dicts
    (a procedural mascot is the default), and mode_key cycles templates."""

    dynamic_scale = 0.15
    dynamic_max_step = 15

    def __init__(self, name: str, frame_buffer: str, output_buffer,
                 mode_key: Union[str, int],
                 templates: Optional[List[dict]] = None,
                 out_shape: Tuple[int, int] = (480, 480),
                 rigid_transform: bool = True):
        super().__init__(name, frame_buffer, output_buffer, enable=True)
        self.mode_key = mode_key
        self.mode_index = 0
        self.out_shape = out_shape
        self.rigid = rigid_transform
        self.register_event(self.mode_key, is_keyboard=True,
                            handler_func=self.switch_mode)
        self._step = 0
        self.resources = [self._prep(t) for t in
                          (templates or [self._default_template()])]

    @staticmethod
    def _default_template():
        import cv2
        img = np.full((480, 480, 3), 235, np.uint8)
        cv2.ellipse(img, (240, 260), (150, 190), 0, 0, 360,
                    (250, 250, 250), -1)
        cv2.ellipse(img, (240, 160), (95, 110), 0, 0, 360,
                    (245, 245, 245), -1)
        cv2.ellipse(img, (240, 165), (78, 92), 0, 0, 360, (60, 160, 255), 3)
        for dx in (-45, 45):
            cv2.circle(img, (240 + dx, 140), 22, (40, 40, 40), -1)
        face_poly = [[240 - 60, 120], [240 + 60, 120], [240 + 70, 200],
                     [240 - 70, 200]]
        return {'image': img,
                'keypoints': np.array([[195., 140.], [285., 140.],
                                       [240., 190.]]),
                'mask_polygon': np.array(face_poly, np.float32)}

    def _prep(self, tpl: dict) -> dict:
        import cv2
        img = tpl.get('image')
        if img is None:
            img = load_image(tpl['image_path'])
        kpts = np.asarray(tpl['keypoints'], np.float32)
        poly = np.asarray(tpl['mask_polygon'], np.float32)
        mul = 1.0 + self.dynamic_scale
        fx = self.out_shape[0] / img.shape[1] * mul
        fy = self.out_shape[1] / img.shape[0] * mul
        img = cv2.resize(img, None, fx=fx, fy=fy,
                         interpolation=cv2.INTER_CUBIC)
        kpts = kpts * [fx, fy]
        poly = poly * [fx, fy]
        mask = cv2.fillPoly(np.zeros(img.shape[:2], np.uint8),
                            [poly.astype(np.int32)], 1)
        return {'image': img, 'keypoints': kpts, 'mask': mask}

    def switch_mode(self):
        self.mode_index = (self.mode_index + 1) % len(self.resources)

    def draw(self, frame_msg):
        import cv2
        res = self.resources[self.mode_index]
        tpl_img = res['image'].copy()
        frame = frame_msg.get_image()

        preds = [p for r in (frame_msg.get_pose_results() or [])
                 for p in r['preds']]
        if preds:
            pose_result = (frame_msg.get_pose_results() or [])[0]
            info = pose_result['dataset_info']
            kpts = np.asarray(preds[0]['keypoints'])
            le, re = get_eye_keypoint_ids(info)
            names = {n: i for i, n in enumerate(info.keypoint_names)}
            nose = names.get('nose', 0)
            src_pts = np.stack([kpts[le, :2], kpts[re, :2],
                                kpts[nose, :2]]).astype(np.float32)
            tar_pts = res['keypoints'].astype(np.float32)
            if self.rigid:
                trans, _ = cv2.estimateAffinePartial2D(src_pts, tar_pts)
            else:
                trans, _ = cv2.estimateAffine2D(src_pts, tar_pts)
            if trans is not None:
                warped = cv2.warpAffine(
                    frame, trans,
                    dsize=(tpl_img.shape[1], tpl_img.shape[0]))
                m = res['mask'].astype(bool)
                tpl_img[m] = warped[m]

        # bounce animation (reference DynamicInfo squeeze loop)
        self._step = (self._step + 1) % (2 * self.dynamic_max_step)
        t = abs(self._step - self.dynamic_max_step) / self.dynamic_max_step
        squeeze = 1.0 - self.dynamic_scale * t
        out_w, out_h = self.out_shape
        view = cv2.resize(tpl_img, (out_w, int(out_h * squeeze)))
        canvas = np.full((out_h, out_w, 3), 255, np.uint8)
        canvas[out_h - view.shape[0]:] = view
        return canvas
