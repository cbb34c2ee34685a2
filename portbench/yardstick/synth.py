'''Synthetic Kinect-v2 depth of one mouse in an open-field arena, made on
the device from a seed, and the host prep that turns it into the chunks
``extract`` hands its device path.

The scene: a circular arena whose floor lies near 700 mm from the camera,
tilted by (0.04, 0.02) mm a pixel along (x, y) and rough by 1.5 mm a pixel,
walls at 500 mm outside it; an elliptical mouse 50 mm high (half axes 11%
and 5.5% of the frame's shorter side) with a head bump 36% higher, walking
an arc, its height noisy by 1 mm; 0.1% of the pixels drop out (raw 0).
The prep is the extractor's: height above the background (the floor,
truncated to whole mm), masked to the arena, cropped to the arena's
bounding box, clipped to [0, 100] mm, dropouts sent as 255.

``annotated_views`` draws the same mouse as square top-down views with its
outline polygon and eight keypoints, as a Label Studio export holds them.
'''
import math
from typing import Dict, List

import numpy as np
import torch

FLOOR_DEPTH = 700.0
WALL_DEPTH = 500.0
TILT = (0.04, 0.02)
FLOOR_NOISE = 1.5
MOUSE_HEIGHT = 50.0
DROPOUT = 0.001
MAX_HEIGHT = 100
KEYPOINT_NAMES = ('Nose', 'Left Ear', 'Right Ear', 'Neck', 'Left Hip', 'Right Hip',
                  'TailBase', 'TailTip')
KEYPOINT_PLACES = ((0.95, 0.0), (0.55, 0.45), (0.55, -0.45), (0.35, 0.0),
                   (-0.45, 0.5), (-0.45, -0.5), (-0.9, 0.0), (-1.5, 0.0))


def generator(seed: int, stream: int, device) -> torch.Generator:
    '''A generator on ``device`` for one stream of a run's seed.'''
    return torch.Generator(device).manual_seed((int(seed) * 1009 + stream) % (2 ** 63))


def arena(height: int, width: int, gen: torch.Generator, device):
    '''(floor depth (H, W) f32, arena mask (H, W) bool).'''
    yy, xx = torch.meshgrid(torch.arange(height, device=device, dtype=torch.float32),
                            torch.arange(width, device=device, dtype=torch.float32),
                            indexing='ij')
    dx, dy = xx - width / 2, yy - height / 2
    inside = dx ** 2 + dy ** 2 < (min(height, width) / 2 - 4) ** 2
    floor = FLOOR_DEPTH + TILT[0] * dx + TILT[1] * dy + \
        FLOOR_NOISE * torch.randn((height, width), generator=gen, device=device)
    return torch.where(inside, floor, torch.full_like(floor, WALL_DEPTH)), inside


def walk(n: int, height: int, width: int, stream: int, gen: torch.Generator, device,
         sweep: float = 0.6 * math.pi):
    '''The mouse's centre (x, y) and heading of each of ``n`` frames: stream
    ``stream`` walks its own arc, the same for every seed, so that every
    seed asks for the same work; the seed draws the small turns of the
    heading.'''
    side = min(height, width)
    radius = max(0.0, 0.5 * side - 0.11 * side - 30.0) * 0.6
    phase = 2 * math.pi * ((0.1 + 0.37 * stream) % 1.0)
    t = phase + sweep * torch.arange(n, device=device, dtype=torch.float32) / max(n - 1, 1)
    heading = t + math.pi / 2 + 0.05 * torch.randn(n, generator=gen, device=device)
    return width / 2 + radius * torch.cos(t), height / 2 + radius * torch.sin(t), heading


def render(cx, cy, heading, height: int, width: int, a: float, b: float,
           gen: torch.Generator) -> torch.Tensor:
    '''(n, H, W) f32 heights of the mouse at the given poses.'''
    device = cx.device
    ca, sa = torch.cos(heading)[:, None, None], torch.sin(heading)[:, None, None]
    yy = torch.arange(height, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, None, :]
    u = (xx - cx[:, None, None]) * ca + (yy - cy[:, None, None]) * sa
    v = -(xx - cx[:, None, None]) * sa + (yy - cy[:, None, None]) * ca
    body = (u / a) ** 2 + (v / b) ** 2 <= 1.0
    head = (u - 0.6 * a) ** 2 + v ** 2 <= (0.6 * b) ** 2
    noise = torch.randn((cx.shape[0], height, width), generator=gen, device=device)
    return body * (MOUSE_HEIGHT + noise) + (head & body) * (0.36 * MOUSE_HEIGHT)


def prepped_chunk(n: int, height: int, width: int, seed: int, stream: int, device,
                  block: int = 100) -> torch.Tensor:
    '''(n, h, w) uint8 prepped frames of one stretch of a session, made
    ``block`` frames at a time on ``device``.'''
    gen = generator(seed, stream, device)
    ground, inside = arena(height, width, gen, device)
    rows = torch.nonzero(inside.any(1)).flatten()
    cols = torch.nonzero(inside.any(0)).flatten()
    y0, y1, x0, x1 = int(rows[0]), int(rows[-1]) + 1, int(cols[0]), int(cols[-1]) + 1
    background = ground.to(torch.int32)                 # whole mm, as find_roi keeps it
    cx, cy, heading = walk(n, height, width, stream, gen, device)
    side = min(height, width)
    out = torch.empty((n, y1 - y0, x1 - x0), dtype=torch.uint8, device=device)
    for s in range(0, n, block):
        e = min(n, s + block)
        mouse = render(cx[s:e], cy[s:e], heading[s:e], height, width, 0.11 * side,
                       0.055 * side, gen)
        raw = torch.round(ground[None] - mouse)
        drop = torch.rand(raw.shape, generator=gen, device=device) < DROPOUT
        raw = torch.where(drop, torch.zeros_like(raw), raw).to(torch.int32)
        h = (background[None] - raw) * inside[None]
        h = torch.clamp(h, 0, MAX_HEIGHT).to(torch.uint8)
        h[raw == 0] = 255
        out[s:e] = h[:, y0:y1, x0:x1]
    return out


def annotated_views(n: int, size: int, seed: int) -> List[Dict]:
    '''``n`` top-down (size, size) uint8 views of the mouse, each with its
    outline (24 points) and eight keypoints in pixels. The ``n`` poses are
    the same for every seed, so that every seed asks for the same work; the
    seed orders them and draws the height noise.'''
    poses = np.random.default_rng(0)
    shapes = [(poses.uniform(0.16, 0.22), poses.uniform(0.45, 0.6), *poses.uniform(0.3, 0.7, 2),
               poses.uniform(0, 2 * np.pi)) for _ in range(n)]
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    views = []
    for i in rng.permutation(n):
        along, ratio, fx, fy, heading = shapes[i]
        a = along * size
        b = a * ratio
        cx, cy = fx * size, fy * size
        ca, sa = np.cos(heading), np.sin(heading)
        u = (xx - cx) * ca + (yy - cy) * sa
        v = -(xx - cx) * sa + (yy - cy) * ca
        body = (u / a) ** 2 + (v / b) ** 2 <= 1.0
        head = (u - 0.6 * a) ** 2 + v ** 2 <= (0.6 * b) ** 2
        image = np.where(body, MOUSE_HEIGHT + rng.normal(0, 1.0, body.shape), 0.0) + \
            np.where(head & body, 0.36 * MOUSE_HEIGHT, 0.0)

        def place(along, across):
            return (cx + along * a * ca - across * b * sa, cy + along * a * sa + across * b * ca)

        t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        views.append({'image': np.clip(np.round(image), 0, 255).astype(np.uint8),
                      'outline': [place(np.cos(tt), np.sin(tt)) for tt in t],
                      'keypoints': [place(*p) for p in KEYPOINT_PLACES]})
    return views
