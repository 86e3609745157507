"""Video loading for the interactive chat path (port of
blim_tpu/data/video.py).

`load_video` samples ~1 frame a second, caps the count at `max_num_frames`
(512 by default) rounded down to whole clips, and returns the frames with
the timestamp message the chat prompt embeds. Decoders in the JAX package's
order: decord, then OpenCV. Host numpy only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def sample_frame_indices(
    vlen: int,
    fps: float,
    max_num_frames: int = 512,
    local_num_frames: int = 4,
    sample_fps: int = 1,
) -> np.ndarray:
    """~1 fps uniform sampling, clipped to max frames, rounded to a multiple
    of `local_num_frames` (clips must be whole)."""
    duration = vlen / max(fps, 1e-6)
    num_frames = int(duration * sample_fps)
    num_frames = min(max(num_frames, local_num_frames), max_num_frames)
    num_frames = max(num_frames // local_num_frames, 1) * local_num_frames
    return np.linspace(0, max(vlen - 2, 0), num_frames).astype(int)


def load_video(
    video_path: str,
    max_num_frames: int = 512,
    local_num_frames: int = 4,
    max_duration: Optional[float] = None,
) -> Tuple[np.ndarray, str]:
    """Returns ((T, H, W, 3) uint8 frames, time message string)."""
    try:
        from decord import VideoReader

        vr = VideoReader(video_path, num_threads=1)
        vlen, fps = len(vr), vr.get_avg_fps()
        if max_duration and vlen / fps > max_duration:
            vlen = int(max_duration * fps)
        idx = sample_frame_indices(vlen, fps, max_num_frames, local_num_frames)
        frames = vr.get_batch(idx).asnumpy()
        duration = vlen / float(fps)
    except ImportError:
        import cv2

        cap = cv2.VideoCapture(video_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        all_frames = []
        ok, frame = cap.read()
        while ok:
            all_frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            ok, frame = cap.read()
        cap.release()
        vlen = len(all_frames)
        if max_duration and vlen / fps > max_duration:
            vlen = int(max_duration * fps)
        idx = sample_frame_indices(vlen, fps, max_num_frames, local_num_frames)
        frames = np.stack([all_frames[i] for i in idx])
        duration = vlen / float(fps)

    secs = [str(round(i / fps, 1)) for i in idx]
    msg = (
        f"The video lasts for {duration:.2f} seconds, "
        f"and {len(secs)} frames are uniformly sampled from it."
    )
    return frames, msg
