"""The frame loop the video demos share: read, pose, draw, write."""
from __future__ import annotations

import os

from ..utils.video import video_writer


def open_video(path):
    """(cv2 capture, fps, (w, h)) of the video at `path`; raises if cv2
    cannot open it."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f'cv2 cannot open the video {path!r}')
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    return cap, fps, size


def run_video(video, out_root, prefix, max_frames, draw):
    """Write draw(frame_index, BGR frame) -> BGR image for every frame of
    `video` (at most `max_frames` where it is set) to
    out_root/prefix+basename; returns (frames, output path)."""
    cap, fps, size = open_video(video)
    os.makedirs(out_root, exist_ok=True)
    out_path = os.path.join(out_root, prefix + os.path.basename(video))
    writer = video_writer(out_path, fps, size)
    n = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok or (max_frames and n >= max_frames):
                break
            writer.write(draw(n, frame))
            n += 1
    finally:
        writer.release()
        cap.release()
    return n, out_path
