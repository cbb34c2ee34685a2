'''Synthetic prepped depth chunks: an elliptical "mouse" on an arena floor.

Frames look like the host prep's output (``prep_raw_frames_host``): heights
above the floor in uint8, zero on the floor and outside the arena, and
Kinect dropout pixels sentinel-encoded as 255. Made with numpy from a seed.

``write_raw_session`` writes the same mouse as a raw MoSeq session on disk
(``depth.dat``, ``metadata.json``, ``depth_ts.txt``) over ``arena_ground``:
a tilted, rough floor near ``FLOOR_DEPTH`` inside a circular arena ringed by
walls at ``WALL_DEPTH``, so that the host prep of its frames gives chunks
like these, and the plane RANSAC of its background weighs hypotheses that
really differ.

``codec_fixture_frames`` makes the frames of the committed libavcodec FFV1
fixture (``tests/data/ffv1_libavcodec_130x106.avi``): session-like depth
with dropouts, a saturated patch and a patch of full-range noise, so that
16-bit samples above 32767 are coded too.

``write_annotated_views`` writes a Label Studio export of the same mouse:
``_depth.png`` views (as ``dataset.py`` writes sampled frames) with an
outline polygon and eight keypoints along the body axis per view.

``proposal_pool`` makes an NMS candidate pool as the RPN's proposal
selection hands it over: anchors decoded by deltas and clipped, per level.
'''
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

MOUSE_HEIGHT = 50.0      # body height above the floor
FLOOR_DEPTH = 700        # mm from the camera
WALL_DEPTH = 500
FLOOR_TILT = (0.04, 0.02)  # mm per pixel along x and y (a camera a little off square)
FLOOR_NOISE = 1.5          # mm, the floor's roughness: per pixel, fixed over a session


def _mouse_heights(n: int, height: int, width: int, rng: np.random.Generator,
                   axes: Optional[Tuple[float, float]], sweep: float) -> Iterator[np.ndarray]:
    '''(height, width) f32 heights above the floor of a mouse walking an arc
    of ``sweep`` radians over ``n`` frames.'''
    side = min(height, width)
    a, b = axes if axes is not None else (0.11 * side, 0.055 * side)
    radius = max(0.0, 0.5 * side - a - 30.0) * 0.6
    phase = rng.uniform(0, 2 * np.pi)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i in range(n):
        t = phase + sweep * i / max(n - 1, 1)
        cx = width / 2 + radius * np.cos(t)
        cy = height / 2 + radius * np.sin(t)
        heading = t + np.pi / 2 + rng.normal(0, 0.05)
        ca, sa = np.cos(heading), np.sin(heading)
        u = (xx - cx) * ca + (yy - cy) * sa          # along the body
        v = -(xx - cx) * sa + (yy - cy) * ca
        body = (u / a) ** 2 + (v / b) ** 2 <= 1.0
        head = (u - 0.6 * a) ** 2 + v ** 2 <= (0.6 * b) ** 2
        frame = np.where(body, MOUSE_HEIGHT, 0.0) + np.where(head & body, 0.36 * MOUSE_HEIGHT, 0.0)
        yield frame + np.where(body, rng.normal(0, 1.0, frame.shape), 0.0)


def _present(i: int, absent: Optional[Tuple[int, int]]) -> bool:
    return absent is None or not absent[0] <= i < absent[1]


def make_sentinel_chunk(n: int, height: int, width: int, seed: int = 0,
                        axes: Optional[Tuple[float, float]] = None,
                        dropout_rate: float = 0.001,
                        absent: Optional[Tuple[int, int]] = None) -> np.ndarray:
    '''(n, height, width) uint8 frames of a mouse walking an arc.

    ``axes`` are the body ellipse's half axes in pixels (default 11% and
    5.5% of the shorter side). The body is ``MOUSE_HEIGHT`` high with a
    head bump 36% higher at its front end, plus unit noise; the floor is
    exactly 0. Dropouts land anywhere with probability ``dropout_rate``.
    Frames ``absent[0] <= i < absent[1]`` show the bare floor (the mouse's
    walk is drawn all the same, so the other frames do not change).
    '''
    rng = np.random.default_rng(seed)
    frames = np.zeros((n, height, width), np.float32)
    for i, frame in enumerate(_mouse_heights(n, height, width, rng, axes, 0.6 * np.pi)):
        if _present(i, absent):
            frames[i] = frame
    out = np.clip(np.round(frames), 0, 254).astype(np.uint8)
    out[rng.random(out.shape) < dropout_rate] = 255
    return out


def arena_ground(height: int, width: int, rng: np.random.Generator,
                 tilt: Tuple[float, float] = FLOOR_TILT,
                 noise: float = FLOOR_NOISE) -> np.ndarray:
    '''(height, width) f32 depth of the bare arena: inside a circle, a floor
    at ``FLOOR_DEPTH`` at the centre, tilted by ``tilt`` mm per pixel along
    (x, y) and rough by normal ``noise`` mm per pixel; walls at
    ``WALL_DEPTH`` outside.'''
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    dx, dy = xx - width / 2, yy - height / 2
    arena = dx ** 2 + dy ** 2 < (min(height, width) / 2 - 4) ** 2
    floor = FLOOR_DEPTH + tilt[0] * dx + tilt[1] * dy \
        + rng.normal(0, noise, (height, width)).astype(np.float32)
    return np.where(arena, floor, np.float32(WALL_DEPTH)).astype(np.float32)


def rough_arena(height: int, width: int, seed: int = 0, noise: float = 8.0) -> np.ndarray:
    '''(height, width) f32 background on which the plane RANSAC weighs many
    near hypotheses: ``arena_ground`` rough by ``noise`` mm (a quarter of
    the RANSAC's 30-mm tolerance, so that planes through three floor points
    differ in their inliers and mean distance), a box at 600 mm on the floor
    (outside the depth range: a hole in the floor's region) and a ledge at
    690 mm in a corner (within the tolerance: a second region).'''
    rng = np.random.default_rng(seed)
    image = arena_ground(height, width, rng, noise=noise)
    by, bx, bh, bw = int(0.4 * height), int(0.47 * width), height // 12, width // 14
    image[by:by + bh, bx:bx + bw] = 600.0
    lh, lw = height // 9, width // 9
    image[:lh, :lw] = 690.0 + rng.normal(0, 1.0, (lh, lw)).astype(np.float32)
    return image


def write_raw_session(dirname: str, nframes: int, height: int = 424, width: int = 512,
                      seed: int = 0, dropout_rate: float = 0.001,
                      absent: Optional[Tuple[int, int]] = None) -> str:
    '''Write a raw session of ``nframes`` (height, width) frames into
    ``dirname``: ``depth.dat`` ('<u2' mm), ``metadata.json`` and
    ``depth_ts.txt`` (30 frames/s); returns the path of ``depth.dat``.

    The mouse (``make_sentinel_chunk``'s) walks three quarters of a circle
    over the session, so that every 500th frame finds it elsewhere and their
    median is the bare arena. Raw 0 marks a dropout. In frames
    ``absent[0] <= i < absent[1]`` the mouse is away: the bare arena
    (``absent`` covering frame 0 makes a session shorter than 500 frames
    find the bare arena as its background).
    '''
    os.makedirs(dirname, exist_ok=True)
    rng = np.random.default_rng(seed)
    ground = arena_ground(height, width, rng)
    path = os.path.join(dirname, 'depth.dat')
    with open(path, 'wb') as fh:
        for i, mouse in enumerate(_mouse_heights(nframes, height, width, rng, None,
                                                 1.5 * np.pi)):
            frame = np.round(ground - mouse * _present(i, absent)).astype('<u2')
            frame[rng.random(frame.shape) < dropout_rate] = 0
            fh.write(frame.tobytes())
    with open(os.path.join(dirname, 'metadata.json'), 'w', encoding='utf-8') as fh:
        json.dump({'DepthResolution': [width, height], 'SubjectName': 'synthetic',
                   'SessionName': 'synthetic-session'}, fh)
    np.savetxt(os.path.join(dirname, 'depth_ts.txt'), np.arange(nframes) * (1000.0 / 30.0),
               fmt='%.3f')
    return path


CODEC_FIXTURE_SEED = 14


def codec_fixture_frames(nframes: int = 26, height: int = 106, width: int = 130,
                         seed: int = CODEC_FIXTURE_SEED) -> np.ndarray:
    '''(nframes, height, width) uint16 frames: the arena and the walking
    mouse of ``write_raw_session`` with 1% dropouts, an 8x8 patch at 65535
    and a 6x10 patch of uniform 16-bit noise, all from ``seed``.'''
    rng = np.random.default_rng(seed)
    ground = arena_ground(height, width, rng)
    out = np.empty((nframes, height, width), np.uint16)
    for i, mouse in enumerate(_mouse_heights(nframes, height, width, rng, None, np.pi)):
        frame = np.round(ground - mouse).astype(np.uint16)
        frame[rng.random(frame.shape) < 0.01] = 0
        frame[4:12, 4:12] = 65535
        frame[-10:-4, -14:-4] = rng.integers(0, 65536, (6, 10))
        out[i] = frame
    return out


KEYPOINT_NAMES = ('Nose', 'Left Ear', 'Right Ear', 'Neck', 'Left Hip', 'Right Hip',
                  'TailBase', 'TailTip')
# each keypoint's place on the body ellipse, in half axes (along, across)
_KEYPOINT_PLACES = ((0.95, 0.0), (0.55, 0.45), (0.55, -0.45), (0.35, 0.0),
                    (-0.45, 0.5), (-0.45, -0.5), (-0.9, 0.0), (-1.5, 0.0))


def write_annotated_views(dirname: str, n: int, size: int = 150, seed: int = 0,
                          outline_points: int = 24) -> str:
    '''Write ``n`` (size, size) uint8 ``_depth.png`` views of the mouse at
    random poses and their Label Studio export (``export.json``: a polygon of
    the body's outline and the eight keypoints, in percent coordinates);
    returns the export's path.'''
    from moseq2_detectron_extract_tpu_torch.io.image import write_image
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    os.makedirs(dirname, exist_ok=True)
    tasks = []
    for i in range(n):
        a = rng.uniform(0.16, 0.22) * size
        b = a * rng.uniform(0.45, 0.6)
        cx, cy = rng.uniform(0.3, 0.7, 2) * size
        heading = rng.uniform(0, 2 * np.pi)
        ca, sa = np.cos(heading), np.sin(heading)
        u = (xx - cx) * ca + (yy - cy) * sa
        v = -(xx - cx) * sa + (yy - cy) * ca
        body = (u / a) ** 2 + (v / b) ** 2 <= 1.0
        head = (u - 0.6 * a) ** 2 + v ** 2 <= (0.6 * b) ** 2
        frame = np.where(body, MOUSE_HEIGHT + rng.normal(0, 1.0, body.shape), 0.0) + \
            np.where(head & body, 0.36 * MOUSE_HEIGHT, 0.0)
        name = f'view_{i:03d}_depth.png'
        write_image(os.path.join(dirname, name), np.clip(frame, 0, 255), scale=False,
                    dtype='uint8')

        def to_image(along, across):
            return (cx + along * a * ca - across * b * sa,
                    cy + along * a * sa + across * b * ca)

        t = np.linspace(0, 2 * np.pi, outline_points, endpoint=False)
        outline = [to_image(np.cos(tt), np.sin(tt)) for tt in t]
        base = {'original_width': size, 'original_height': size, 'image_rotation': 0}
        result = [dict(base, type='polygonlabels', from_name='label', to_name='image',
                       value={'points': [[100.0 * x / size, 100.0 * y / size]
                                         for x, y in outline],
                              'polygonlabels': ['mouse']})]
        for kp_name, (along, across) in zip(KEYPOINT_NAMES, _KEYPOINT_PLACES):
            x, y = to_image(along, across)
            result.append(dict(base, type='keypointlabels', from_name='kp', to_name='image',
                               value={'x': 100.0 * x / size, 'y': 100.0 * y / size,
                                      'width': 0.5, 'keypointlabels': [kp_name]}))
        tasks.append({'id': i + 1,
                      'data': {'image': os.path.join(dirname, f'{i:08x}-{name}')},
                      'annotations': [{'id': i + 1, 'result': result}]})
    path = os.path.join(dirname, 'export.json')
    with open(path, 'w', encoding='utf-8') as fh:
        json.dump(tasks, fh)
    return path


def proposal_pool(b: int, level_k: Tuple[int, ...], canvas: int = 256, seed: int = 0):
    """(B, K) NMS candidates as ``models/rpn.py:select_proposals`` makes
    them, K the sum of ``level_k``: per level, anchors of size 32 x 2^l at
    aspect ratios 0.5, 1 and 2 around random centres, decoded by random
    deltas and clipped to the canvas; descending logits as scores. Returns
    CPU tensors boxes (B, K, 4) f32, scores (B, K) f32, levels (B, K) int32
    and valid (B, K) bool (the non-empty boxes)."""
    import torch
    from moseq2_detectron_extract_tpu_torch.ops.boxes import (clip_boxes, decode_boxes,
                                                              nonempty_boxes)
    rng = np.random.default_rng(seed)
    parts = []
    for level, k in enumerate(level_k):
        centre = rng.uniform(0, canvas, (b, k, 2))
        ratio = rng.choice([0.5, 1.0, 2.0], (b, k))
        size = 32.0 * 2 ** level
        wh = np.stack([size / np.sqrt(ratio), size * np.sqrt(ratio)], -1)
        anchors = np.concatenate([centre - wh / 2, centre + wh / 2], -1).astype('float32')
        deltas = rng.normal(0, 0.4, (b, k, 4)).astype('float32')
        boxes = clip_boxes(decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors)),
                           torch.full((b, 2), float(canvas)))
        scores = np.sort(rng.normal(0, 2, (b, k)), -1)[:, ::-1].astype('float32')
        parts.append((boxes, torch.from_numpy(scores.copy()),
                      torch.full((b, k), level, dtype=torch.int32), nonempty_boxes(boxes)))
    return tuple(torch.cat(p, 1) for p in zip(*parts))
