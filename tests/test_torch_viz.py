'''The preview's drawing and views on the CPU, against the JAX package and
against cv2 5.0 where the JAX package draws with cv2.

* ``apply_colormap_jet`` (uint8 and float input, RGB and BGR, with and
  without ``out``), ``stack_videos`` and ``ops/draw.py:blend_mask`` (the
  JAX ``_blend_mask``): equal to the JAX package's.
* Each primitive of ``ops/draw.py`` against cv2 on random frames, colours
  and end points (inside, on and beyond the frame's edges): the
  anti-aliased line, the filled anti-aliased circle (radius 0-2), the
  rectangle, the anti-aliased contours, the digits at both text sizes and
  the linear resize. The task allowed a tolerance for the anti-aliased
  primitives and the text; the port reaches equality with cv2 5.0 (every
  pixel cv2 changes the port changes, to the same level, and no other), so
  the tests hold equality. The C++ core equals the plain versions exactly.
* The digits' glyph tables equal cv2 5.0's rendering of each digit.
* The three views (``ArenaView``, ``RotatedKeypointsView``,
  ``CleanedFramesView``) on the same inputs against the JAX views drawn with
  cv2: equal.
'''
import cv2
import numpy as np
import pytest

from moseq2_detectron_extract_tpu import viz as jviz
from moseq2_detectron_extract_tpu.io import video as jvideo
from moseq2_detectron_extract_tpu_torch import viz as pviz
from moseq2_detectron_extract_tpu_torch.io import video as pvideo
from moseq2_detectron_extract_tpu_torch.ops import draw

FONT = cv2.FONT_HERSHEY_SIMPLEX
TEXT = {'stamp': (1.0, 2), 'index': (0.4, 1)}


def _points(rng, n, lo=-12, hi=64):
    return [tuple(int(v) for v in rng.integers(lo, hi, 2)) for _ in range(n)]


@pytest.mark.parametrize('order', ['rgb', 'bgr'])
@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_colormap_equals_jax(order, dtype):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (3, 17, 23)).astype(dtype)
    if dtype == 'float32':
        frames = frames * 0.47 - 11.3
    for vmin, vmax in ((0, 100), (20, 60)):
        ref = jvideo.apply_colormap_jet(frames, vmin, vmax, order=order)
        np.testing.assert_array_equal(pvideo.apply_colormap_jet(frames, vmin, vmax, order=order),
                                      ref)
        out = np.zeros(frames.shape + (3,), np.uint8)
        assert pvideo.apply_colormap_jet(frames, vmin, vmax, out=out, order=order) is out
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(pviz.colorize_video(frames), jviz.colorize_video(frames))


@pytest.mark.parametrize('orientation', ['horizontal', 'vertical', 'diagional'])
def test_stack_videos_equals_jax(orientation):
    rng = np.random.default_rng(1)
    videos = [rng.integers(0, 256, (4, h, w, 3), dtype=np.uint8)
              for h, w in ((10, 12), (7, 15), (12, 5))]
    ref = jviz.stack_videos(videos, orientation)
    np.testing.assert_array_equal(pviz.stack_videos(videos, orientation), ref)
    out = rng.integers(0, 256, ref.shape, dtype=np.uint8)       # a reused buffer's garbage
    assert pviz.stack_videos(videos, orientation, out=out) is out
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize('alpha', [0.3, 0.7])
def test_blend_mask_equals_jax(alpha):
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (3, 30, 40, 3), dtype=np.uint8)
    masks = (rng.random((3, 30, 40)) > 0.6).astype(np.uint8)
    color = (0, 0, 255)
    ref, ours = frames.copy(), frames.copy()
    for i in range(3):
        jviz._blend_mask(ref[i], masks[i], color=color, alpha=alpha)
        draw.blend_mask(ours[i], masks[i], color=color, alpha=alpha)
    np.testing.assert_array_equal(ours, ref)
    # the C++ core's windows, at origins and cut by the frame's edges
    crops = (rng.random((3, 16, 16)) > 0.5).astype(np.uint8)
    origins = np.array([[0, 0], [14, 24], [20, 30]])
    windowed = frames.copy()
    draw.blend_windows(windowed, crops, origins, color, alpha)
    plain = frames.copy()
    for i, (y0, x0) in enumerate(origins):
        region = plain[i, y0:y0 + 16, x0:x0 + 16]
        draw.blend_mask(region, crops[i][:region.shape[0], :region.shape[1]], color, alpha)
    np.testing.assert_array_equal(windowed, plain)


def _random_draws(seed, n, h, w, kinds):
    '''A DrawList of random records and the same drawn by cv2.'''
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    ref = frames.copy()
    draws = draw.DrawList()
    for k in range(120):
        f = int(rng.integers(0, n))
        kind = kinds[k % len(kinds)]
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        p0, p1 = _points(rng, 2, -12, max(h, w) + 12)
        if kind == 'line':
            cv2.line(ref[f], p0, p1, color, 1, cv2.LINE_AA)
            draws.line(f, p0, p1, color)
        elif kind == 'circle':
            r = int(rng.integers(0, 3))
            cv2.circle(ref[f], p0, r, color, -1, cv2.LINE_AA)
            draws.circle(f, p0, r, color)
        elif kind == 'rectangle':
            cv2.rectangle(ref[f], p0, p1, color)
            draws.rectangle(f, p0, p1, color)
        else:
            size = ('stamp', 'index')[k % 2]
            value = int(rng.integers(0, 10 ** int(rng.integers(1, 7))))
            cv2.putText(ref[f], str(value), p0, FONT, TEXT[size][0], color, TEXT[size][1],
                        cv2.LINE_AA)
            draws.number(f, value, p0, size, color)
    return frames, ref, draws


@pytest.mark.parametrize('kind', ['line', 'circle', 'rectangle', 'text'])
def test_primitive_equals_cv2(kind):
    frames, ref, draws = _random_draws(3, 4, 37, 51, [kind])
    plain = draws.draw_plain(frames.copy())
    native = draws.draw(frames.copy())
    changed = (ref != frames).any(-1)
    print(f'{kind}: cv2 changed {int(changed.sum())} pixels; the port changed '
          f'{int(((plain != frames).any(-1) & changed).sum())} of them, '
          f'largest level difference {int(np.abs(plain.astype(int) - ref).max())}')
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(native, plain)


def test_mixed_records_in_order():
    frames, ref, draws = _random_draws(4, 3, 40, 40, ['line', 'circle', 'text', 'rectangle'])
    np.testing.assert_array_equal(draws.draw(frames.copy()), ref)


def test_contours_equal_cv2():
    from moseq2_detectron_extract_tpu_torch.io.annot import mask_to_poly
    rng = np.random.default_rng(5)
    for _ in range(12):
        mask = np.zeros((40, 50), np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            cv2.ellipse(mask, tuple(int(v) for v in rng.integers(3, 47, 2)),
                        tuple(int(v) for v in rng.integers(1, 16, 2)),
                        float(rng.integers(0, 180)), 0, 360, 1, -1)
        mask[int(rng.integers(0, 40)), int(rng.integers(0, 50))] = 1
        contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        ref = np.zeros((40, 50), np.uint8)
        cv2.drawContours(ref, contours, -1, 255, 1, cv2.LINE_AA)
        ours = mask_to_poly(mask)
        draws = draw.DrawList()
        draws.contours(0, ours, (255,))
        np.testing.assert_array_equal(draws.draw(np.zeros((1, 40, 50), np.uint8))[0], ref)
        plain = np.zeros((40, 50), np.uint8)
        draw.draw_contours_aa(plain, ours, (255,))
        np.testing.assert_array_equal(plain, ref)


@pytest.mark.parametrize('size', ['stamp', 'index'])
def test_digit_glyphs_are_cv2s(size):
    '''Each digit's coverage table is cv2 5.0's rendering of it (white on
    black) at the text origin's offset.'''
    table, spec = draw.glyph_table(size), draw.GLYPH_SIZES[size]
    scale, thickness = TEXT[size]
    assert (spec['scale'], spec['thickness']) == (scale, thickness)
    for d in range(10):
        canvas = np.zeros((80, 80), np.uint8)
        cv2.putText(canvas, str(d), (30, 50), FONT, scale, 255, thickness, cv2.LINE_AA)
        gh, gw = table.shape[1:]
        top, left = 50 + spec['top'], 30 + spec['left']
        np.testing.assert_array_equal(canvas[top:top + gh, left:left + gw], table[d])
        assert canvas.sum() == int(table[d].sum())               # nothing outside the cell
    assert cv2.getTextSize('0', FONT, scale, thickness)[0][0] in (spec['advance'],
                                                                  spec['advance'] + 1)


@pytest.mark.parametrize('shape', [(80, 80, 3), (33, 47, 3), (7, 5, 3), (20, 30)])
def test_resize_equals_cv2(shape):
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (3,) + shape, dtype=np.uint8)
    size = (int(shape[1] * 1.5), int(shape[0] * 1.5))
    ref = np.stack([cv2.resize(f, size) for f in frames])
    np.testing.assert_array_equal(np.stack([draw.resize_linear(f, size) for f in frames]), ref)
    np.testing.assert_array_equal(draw.resize_linear_block(frames, size), ref)


# -- the views -------------------------------------------------------------------

def _scene(seed=7, n=5, h=60, w=72, c=24, crop=20):
    '''Depth frames, a ROI, mask windows, boxes (some NaN), keypoints (some
    NaN, some off the frame) and rotated crops for the views.'''
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    roi = (((yy - h / 2) / (h / 2.3)) ** 2 + ((xx - w / 2) / (w / 2.2)) ** 2 < 1).astype(np.uint8)
    frames = (rng.integers(0, 90, (n, h, w)) * roi).astype(np.uint8)
    crops = np.zeros((n, c, c), np.uint8)
    crops[:, 6:18, 4:20] = 1
    origins = np.stack([rng.integers(0, h - c, n), rng.integers(0, w - c, n)], axis=1)
    boxes = np.stack([origins[:, 1] + 3.7, origins[:, 0] + 2.2, origins[:, 1] + 20.9,
                      origins[:, 0] + 19.5], axis=1)[:, None, :].repeat(2, axis=1)
    boxes[:, 1] += 5.3
    boxes[1, 1] = np.nan
    kpts = np.concatenate([rng.uniform(-3, w + 3, (n, 8, 1)), rng.uniform(-3, h + 3, (n, 8, 1)),
                           np.ones((n, 8, 1))], axis=-1)
    kpts[2, 3, :2] = np.nan
    masks = np.zeros((n, crop, crop), np.uint8)
    masks[:, 5:15, 3:17] = 1
    clean = rng.integers(0, 120, (n, crop, crop)).astype(np.uint8)
    rot = rng.uniform(-12, 12, (n, 8, 2))
    rot[3, 0] = np.nan
    return {'frames': frames, 'roi': roi, 'crops': crops, 'origins': origins, 'boxes': boxes,
            'kpts': kpts, 'masks': masks, 'clean': clean, 'rot': rot}


@pytest.mark.parametrize('order', ['rgb', 'bgr'])
def test_arena_view_equals_jax(order):
    s = _scene()
    ours = pviz.ArenaView(s['roi'], order=order)
    ref = jviz.ArenaView(s['roi'], order=order)
    kwargs = dict(keypoints=s['kpts'], boxes=s['boxes'], mask_crops=s['crops'],
                  mask_origins=s['origins'])
    np.testing.assert_array_equal(ours.render(s['frames'], **kwargs),
                                  ref.render(s['frames'], **kwargs))
    full = np.zeros(s['frames'].shape, np.uint8)
    for i, (y0, x0) in enumerate(s['origins']):
        full[i, y0:y0 + 24, x0:x0 + 24] = s['crops'][i]
    out = np.zeros(s['frames'].shape + (3,), np.uint8)
    got = ours.render(s['frames'], masks=full, keypoints=s['kpts'], boxes=s['boxes'][:, 0],
                      out=out)
    assert got is out
    np.testing.assert_array_equal(got, ref.render(s['frames'], masks=full, keypoints=s['kpts'],
                                                  boxes=s['boxes'][:, 0]))


@pytest.mark.parametrize('order', ['rgb', 'bgr'])
def test_rotated_keypoints_view_equals_jax(order):
    s = _scene()
    out = np.full((5, 30, 30, 3), 9, np.uint8)
    ours = pviz.RotatedKeypointsView(order=order).render(s['masks'], s['rot'], out=out)
    ref = jviz.RotatedKeypointsView(order=order).render(s['masks'], s['rot'])
    assert ours is out
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize('order', ['rgb', 'bgr'])
def test_cleaned_frames_view_equals_jax(order):
    s = _scene()
    ours = pviz.CleanedFramesView(order=order).render(s['clean'], s['masks'])
    ref = jviz.CleanedFramesView(order=order).render(s['clean'], s['masks'])
    np.testing.assert_array_equal(ours, ref)
    out = np.zeros((5, 30, 30, 3), np.uint8)
    assert pviz.CleanedFramesView(order=order).render(s['clean'], s['masks'], out=out) is out
    np.testing.assert_array_equal(out, ref)


def test_draw_keypoints_equals_jax():
    s = _scene()
    image = np.ascontiguousarray(np.random.default_rng(8).integers(0, 256, (60, 72, 3),
                                                                    dtype=np.uint8))
    ref = jviz.draw_keypoints(image.copy(), s['kpts'][2])
    np.testing.assert_array_equal(pviz.draw_keypoints(image.copy(), s['kpts'][2]), ref)
