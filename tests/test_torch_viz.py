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
* The score text (``put_text`` at the 'score' size: scale 0.35, thickness
  1, ``LINE_8``, the digits and '.'): each glyph is cv2 5.0's, and whole
  scores equal ``cv2.putText`` on random colour images, clipped at every
  edge.
* The single-image views (``draw_mask_contour``, ``draw_instances``,
  ``draw_annotation_item``, ``visualize_annotations`` with and without
  matplotlib, ``visualize_inference`` at three scales and on tensors)
  against the JAX functions drawn with cv2 5.0: equal, pixel for pixel.
'''
import sys

import cv2
import numpy as np
import pytest
import torch

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


def test_score_glyphs_are_cv2s():
    '''Each character's coverage table is cv2 5.0's ``LINE_8`` rendering of it
    at scale 0.35 (the same as ``LINE_AA``'s).'''
    table, spec = draw.glyph_table('score'), draw.GLYPH_SIZES['score']
    assert (spec['scale'], spec['thickness'], spec['chars']) == (0.35, 1, '0123456789.')
    gh, gw = table.shape[1:]
    for i, ch in enumerate(spec['chars']):
        for line_type in (cv2.LINE_8, cv2.LINE_AA):
            canvas = np.zeros((40, 40), np.uint8)
            cv2.putText(canvas, ch, (12, 20), FONT, 0.35, 255, 1, line_type)
            top, left = 20 + spec['top'], 12 + spec['left']
            np.testing.assert_array_equal(canvas[top:top + gh, left:left + gw], table[i])
            assert canvas.sum() == int(table[i].sum())
        step = spec['advances'].get(ch, spec['advance'])
        assert cv2.getTextSize(ch, FONT, 0.35, 1)[0][0] in (step, step + 1)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_score_text_equals_cv2(seed):
    '''Scores as ``draw_instances`` writes them, on random colour images and
    origins inside the image and past each edge (so a glyph is cut at the
    right, the bottom, the top or the left).'''
    rng = np.random.default_rng(seed)
    for t in range(200):
        h, w = (int(v) for v in rng.integers(6, 30, 2))
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ref = image.copy()
        text = f'{rng.uniform(0, 1):.2f}'
        org = (int(rng.integers(-20, w + 2)), int(rng.integers(-2, h + 8)))
        color = (255, 255, 255) if t % 2 else tuple(int(v) for v in rng.integers(0, 256, 3))
        cv2.putText(ref, text, org, FONT, 0.35, color, 1)
        draw.put_text(image, text, org, 'score', color)
        np.testing.assert_array_equal(image, ref, err_msg=f'{text} at {org} on {h}x{w}')
    with pytest.raises(ValueError, match='draws only'):
        draw.put_text(image, '-0.5', (2, 10), 'score', (255, 255, 255))


def _blob_masks(seed, d=3, h=40, w=52):
    '''Instance masks: ellipses, one with a hole and a second piece, one
    cut by the frame's top-left corner (the score's text then starts at
    row 0), and one empty.'''
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.zeros((d + 1, h, w), bool)
    for i in range(d):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ay, ax = rng.uniform(4, 12, 2)
        masks[i] = ((yy - cy) / ay) ** 2 + ((xx - cx) / ax) ** 2 < 1
    masks[0] |= ((yy - 3) / 5.0) ** 2 + ((xx - 4) / 7.0) ** 2 < 1
    masks[1, 20:22, 25:28] = False
    masks[1, 30:33, 2:6] = True
    return masks


def _instance_keypoints(seed, d, h=40, w=52):
    rng = np.random.default_rng(seed)
    kp = np.concatenate([rng.uniform(-2, w + 2, (d, 8, 1)), rng.uniform(-2, h + 2, (d, 8, 1)),
                         rng.uniform(0, 1, (d, 8, 1))], axis=-1)
    kp[0, 2, :2] = np.nan
    return kp


@pytest.mark.parametrize('seed', [0, 1])
def test_draw_mask_contour_equals_jax(seed):
    image = np.random.default_rng(seed).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    for mask in _blob_masks(seed):
        for color in ((255, 255, 255), (0, 200, 255)):
            ref = jviz.draw_mask_contour(image.copy(), mask, color)
            np.testing.assert_array_equal(pviz.draw_mask_contour(image.copy(), mask, color), ref)


@pytest.mark.parametrize('with_scores', [True, False])
def test_draw_instances_equals_jax(with_scores):
    masks = _blob_masks(3)
    kp = _instance_keypoints(4, len(masks))
    scores = np.array([0.987, 0.5, 0.0449, 1.0], np.float32) if with_scores else None
    image = np.ascontiguousarray(np.random.default_rng(5).integers(0, 256, (40, 52, 3),
                                                                    dtype=np.uint8))
    ref = jviz.draw_instances(image.copy(), masks, kp, scores)
    np.testing.assert_array_equal(pviz.draw_instances(image.copy(), masks, kp, scores), ref)


def _prediction(seed):
    masks = _blob_masks(seed)
    d = len(masks)
    return {'masks': masks, 'keypoints': _instance_keypoints(seed, d).astype(np.float32),
            'scores': np.random.default_rng(seed).uniform(0, 1, d).astype(np.float32),
            'valid': np.array([True, True, False, True])}


@pytest.mark.parametrize('scale', [2.0, 1.0, 1.5])
def test_visualize_inference_equals_jax(scale):
    frame = np.random.default_rng(6).uniform(-20, 140, (40, 52)).astype(np.float32)
    pred = _prediction(7)
    ref = jviz.visualize_inference(frame, pred, 10.0, 100.0, scale=scale)
    ours = pviz.visualize_inference(frame, pred, 10.0, 100.0, scale=scale)
    assert ours.shape == ref.shape == (int(40 * scale), int(52 * scale), 3)
    np.testing.assert_array_equal(ours, ref)
    tensors = {k: torch.from_numpy(v) for k, v in pred.items()}
    np.testing.assert_array_equal(
        pviz.visualize_inference(torch.from_numpy(frame), tensors, 10.0, 100.0, scale=scale),
        ref)
    del pred['valid'], pred['scores']
    np.testing.assert_array_equal(pviz.visualize_inference(frame, pred, 0, 120, scale=scale),
                                  jviz.visualize_inference(frame, pred, 0, 120, scale=scale))


def _annotation_items(tmp_path):
    '''Both packages' items of a synthetic Label Studio export (polygons and
    keypoints), plus one with a mask array and a rescaled intensity.'''
    from moseq2_detectron_extract_tpu.io import annot as jannot
    from moseq2_detectron_extract_tpu_torch.io import annot as pannot
    from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views
    export = write_annotated_views(str(tmp_path / 'views'), 4, size=48, seed=2)
    names = list(jviz.default_keypoint_names)
    items = (jannot.read_annotations(export, names), pannot.read_annotations(export, names))
    mask = np.zeros((48, 48), np.uint8)
    mask[10:30, 8:40] = 1
    extra = dict(items[1][0], rescale_intensity=1.7,
                 annotations=[{'segmentation': mask, 'bbox': [7.6, 9.5, 40.4, 30.2],
                               'keypoints': list(np.arange(24) % 40.0)}])
    return items[0] + [extra], items[1] + [dict(extra)]


def test_draw_annotation_item_equals_jax(tmp_path):
    jax_items, port_items = _annotation_items(tmp_path)
    assert len(port_items) == 5
    for a, b in zip(jax_items, port_items):
        ref = jviz.draw_annotation_item(a)
        ours = pviz.draw_annotation_item(b)
        assert ours.shape == ref.shape and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize('matplotlib', [True, False], ids=['figure', 'array'])
def test_visualize_annotations_equals_jax(tmp_path, monkeypatch, matplotlib):
    jax_items, port_items = _annotation_items(tmp_path)
    if matplotlib:
        import matplotlib as mpl
        mpl.use('Agg')
    else:                                      # the card's machine has no matplotlib
        monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    ref = jviz.visualize_annotations(jax_items, num=3, seed=4)
    ours = pviz.visualize_annotations(port_items, num=3, seed=4)
    if not matplotlib:
        assert isinstance(ours, np.ndarray) and ours.shape == (48, 3 * 48, 3)
        np.testing.assert_array_equal(ours, ref)
        return
    import matplotlib.pyplot as plt
    try:
        assert len(ours[1]) == len(ref[1]) == 3
        for a, b in zip(ours[1], ref[1]):
            np.testing.assert_array_equal(np.asarray(a.images[0].get_array()),
                                          np.asarray(b.images[0].get_array()))
    finally:
        plt.close(ours[0])
        plt.close(ref[0])
