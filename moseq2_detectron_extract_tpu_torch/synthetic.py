'''Synthetic prepped depth chunks: an elliptical "mouse" on an arena floor.

Frames look like the host prep's output (``prep_raw_frames_host``): heights
above the floor in uint8, zero on the floor and outside the arena, and
Kinect dropout pixels sentinel-encoded as 255. Made with numpy from a seed.
'''
from typing import Optional, Tuple

import numpy as np

MOUSE_HEIGHT = 50.0      # body height above the floor


def make_sentinel_chunk(n: int, height: int, width: int, seed: int = 0,
                        axes: Optional[Tuple[float, float]] = None,
                        dropout_rate: float = 0.001) -> np.ndarray:
    '''(n, height, width) uint8 frames of a mouse walking an arc.

    ``axes`` are the body ellipse's half axes in pixels (default 11% and
    5.5% of the shorter side). The body is ``MOUSE_HEIGHT`` high with a
    head bump 36% higher at its front end, plus unit noise; the floor is
    exactly 0. Dropouts land anywhere with probability ``dropout_rate``.
    '''
    rng = np.random.default_rng(seed)
    side = min(height, width)
    a, b = axes if axes is not None else (0.11 * side, 0.055 * side)
    radius = max(0.0, 0.5 * side - a - 30.0) * 0.6
    phase = rng.uniform(0, 2 * np.pi)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    frames = np.zeros((n, height, width), np.float32)
    for i in range(n):
        t = phase + 0.6 * np.pi * i / max(n - 1, 1)
        cx = width / 2 + radius * np.cos(t)
        cy = height / 2 + radius * np.sin(t)
        heading = t + np.pi / 2 + rng.normal(0, 0.05)
        ca, sa = np.cos(heading), np.sin(heading)
        u = (xx - cx) * ca + (yy - cy) * sa          # along the body
        v = -(xx - cx) * sa + (yy - cy) * ca
        body = (u / a) ** 2 + (v / b) ** 2 <= 1.0
        head = (u - 0.6 * a) ** 2 + v ** 2 <= (0.6 * b) ** 2
        frame = np.where(body, MOUSE_HEIGHT, 0.0) + np.where(head & body, 0.36 * MOUSE_HEIGHT, 0.0)
        frame = frame + np.where(body, rng.normal(0, 1.0, frame.shape), 0.0)
        frames[i] = frame
    out = np.clip(np.round(frames), 0, 254).astype(np.uint8)
    out[rng.random(out.shape) < dropout_rate] = 255
    return out
