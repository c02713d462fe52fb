"""Video files for the demos and the webcam sinks."""
from __future__ import annotations


def video_writer(path: str, fps: float, size):
    """An open cv2.VideoWriter for `path` at `fps` and `size` (w, h): MJPG
    for an .avi file (OpenCV's own AVI writer takes it in every build),
    mp4v, the JAX demos' codec, for any other. Raises if cv2 cannot open
    the file with that codec, so that no run writes nothing silently."""
    import cv2
    codec = 'MJPG' if path.lower().endswith('.avi') else 'mp4v'
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps,
                             tuple(int(v) for v in size))
    if not writer.isOpened():
        raise RuntimeError(f'cv2 cannot write {path!r} with codec {codec}')
    return writer
