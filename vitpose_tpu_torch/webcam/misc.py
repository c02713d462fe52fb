"""Image/video helpers for the webcam framework.

Counterpart of the reference tools/webcam/webcam_apis/utils/misc.py
(limit_max_fps, screen_matting, copy_and_paste, expand_and_clamp,
ImageCapture). URL asset download is intentionally absent — this build
targets zero-egress deployments; assets are loaded from disk or generated
procedurally by the effect nodes.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np

_COLORS = {
    'black': (0, 0, 0), 'white': (255, 255, 255), 'red': (0, 0, 255),
    'green': (0, 255, 0), 'blue': (255, 0, 0), 'cyan': (255, 255, 0),
    'yellow': (0, 255, 255), 'magenta': (255, 0, 255),
}


def color_val(color) -> tuple:
    """Resolve a color name or BGR tuple to a BGR tuple."""
    if isinstance(color, str):
        return _COLORS[color.lower()]
    return tuple(int(c) for c in color)


@contextmanager
def limit_max_fps(fps: Optional[float]):
    """Sleep after the body so one iteration takes >= 1/fps seconds
    (reference misc.py:16)."""
    t_start = time.time()
    try:
        yield
    finally:
        if fps is not None:
            t_sleep = 1.0 / fps - (time.time() - t_start)
            if t_sleep > 0:
                time.sleep(t_sleep)


def is_image_file(path) -> bool:
    return isinstance(path, str) and path.lower().endswith(
        ('.png', '.jpg', '.jpeg', '.tiff', '.bmp'))


def load_image(path: str, flags=None):
    """Load an image from disk (BGR, like cv2.imread)."""
    import cv2
    if flags is None:
        flags = cv2.IMREAD_COLOR
    return cv2.imread(path, flags)


class ImageCapture:
    """cv2.VideoCapture lookalike that replays one constant image
    (reference misc.py:301) — lets an image file stand in for a camera."""

    def __init__(self, image):
        self.image = load_image(image) if isinstance(image, str) else image

    def isOpened(self):
        return self.image is not None

    def read(self):
        return True, self.image.copy()

    def release(self):
        pass

    def get(self, prop_id):
        import cv2
        if prop_id == cv2.CAP_PROP_FRAME_WIDTH:
            return self.image.shape[1]
        if prop_id == cv2.CAP_PROP_FRAME_HEIGHT:
            return self.image.shape[0]
        if prop_id == cv2.CAP_PROP_FPS:
            return np.nan
        raise NotImplementedError(prop_id)


class DirectoryCapture:
    """cv2.VideoCapture lookalike over a directory of images — headless
    test/demo source (no reference analogue; the reference only reads
    cameras, videos and single images)."""

    def __init__(self, path: str, loop: bool = False):
        import os
        self._paths = [os.path.join(path, n) for n in sorted(os.listdir(path))
                       if is_image_file(n)]
        self._idx = 0
        self._loop = loop

    def isOpened(self):
        return bool(self._paths)

    def read(self):
        if self._idx >= len(self._paths):
            if not self._loop:
                return False, None
            self._idx = 0
        img = load_image(self._paths[self._idx])
        self._idx += 1
        return img is not None, img

    def release(self):
        pass

    def get(self, prop_id):
        import cv2
        probe = load_image(self._paths[0]) if self._paths else None
        if probe is not None and prop_id == cv2.CAP_PROP_FRAME_WIDTH:
            return probe.shape[1]
        if probe is not None and prop_id == cv2.CAP_PROP_FRAME_HEIGHT:
            return probe.shape[0]
        return np.nan


def screen_matting(img, color_low=None, color_high=None,
                   color: Optional[str] = None):
    """Foreground mask by excluding a screen-color range (reference
    misc.py:123): 1 where the pixel is NOT inside [color_low, color_high]."""
    import cv2
    presets = {
        'g': ((0, 200, 0), (60, 255, 60)),
        'b': ((230, 0, 0), (255, 40, 40)),
        'k': ((0, 0, 0), (40, 40, 40)),
        'w': ((230, 230, 230), (255, 255, 255)),
    }
    if color_low is None or color_high is None:
        if color is None:
            raise ValueError('give color, or color_low and color_high')
        key = color.lower()[0]
        if key not in presets:
            raise NotImplementedError(f'unsupported screen color {color!r}')
        color_low, color_high = presets[key]
    mask = cv2.inRange(img, np.array(color_low), np.array(color_high)) == 0
    return mask.astype(np.uint8)


def expand_and_clamp(box: Sequence[float], im_shape, s: float = 1.25):
    """Expand an xyxy box by `s` about its center and clip to the image
    (reference misc.py:160)."""
    x1, y1, x2, y2 = box[:4]
    dw = (x2 - x1) * (s - 1) / 2
    dh = (y2 - y1) * (s - 1) / 2
    h, w = im_shape[:2]
    return [min(max(0, int(x1 - dw)), w - 1),
            min(max(0, int(y1 - dh)), h - 1),
            min(max(0, int(x2 + dw)), w - 1),
            min(max(0, int(y2 + dh)), h - 1)]


def find_bbox(mask) -> list:
    """Tight xyxy bbox of a binary mask (reference misc.py:205) —
    vectorized instead of the reference's four scan loops."""
    ys, xs = np.nonzero(np.squeeze(mask))
    if len(xs) == 0:
        return [0, 0, mask.shape[1] - 1, mask.shape[0] - 1]
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]


def copy_and_paste(img, background_img, mask, bbox=None,
                   effect_region=(0.2, 0.2, 0.8, 0.8),
                   min_size=(20, 20)):
    """Cut the masked instance out of `img`, resize it to fit the
    normalized `effect_region`, and paste onto `background_img`
    (reference misc.py:252)."""
    import cv2
    out = background_img.copy()
    bh, bw = out.shape[:2]
    region_h = (effect_region[3] - effect_region[1]) * bh
    region_w = (effect_region[2] - effect_region[0]) * bw

    if bbox is None:
        bbox = find_bbox(mask)
    iw, ih = bbox[2] - bbox[0], bbox[3] - bbox[1]
    if iw <= min_size[0] or ih <= min_size[1]:
        return out

    rate = (region_h / ih if region_w / region_h > iw / ih
            else region_w / iw)
    x1, y1, x2, y2 = (int(v) for v in bbox[:4])
    size = (int(rate * iw), int(rate * ih))
    inst = cv2.resize(img[y1:y2, x1:x2], size)
    m = cv2.resize(mask[y1:y2, x1:x2], size,
                   interpolation=cv2.INTER_NEAREST)

    src_ys, src_xs = np.nonzero(m == 1)
    ys = src_ys + int(effect_region[1] * bh)
    xs = src_xs + int(effect_region[0] * bw)
    keep = (ys < bh) & (xs < bw)
    out[ys[keep], xs[keep]] = inst[src_ys[keep], src_xs[keep]]
    return out
