'''Frame clean and morphology: the port against the JAX package.

Clean's plain version is bit-exact against the Pallas kernel run in
interpret mode on arbitrary frames (both embed the frame in a zero halo),
and against the cv2-border ops path ``clean_frames(frames, iters_tail=3)``
on zero-bordered frames; at non-zero borders those two JAX paths differ by
design (``pallas_clean.py:9-13``) and the port follows the TPU kernel.
'''
import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moseq2_detectron_extract_tpu.ops import morphology as jmorph
from moseq2_detectron_extract_tpu.ops.pallas_clean import fused_clean_frames as jax_fused
from moseq2_detectron_extract_tpu.proc.features import clean_frames as jax_clean
from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, morphology
from moseq2_detectron_extract_tpu_torch.proc.features import clean_frames


def blob_frames(rng, n=3, h=100, w=120, margin=16):
    '''Noisy blobs whose frame border (``margin`` px) is zero.'''
    frames = np.zeros((n, h, w), 'uint8')
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        cy, cx = h / 2 + 3 * i, w / 2 - 4 * i
        blob = ((yy - cy) / (h / 2 - margin - 8)) ** 2 + \
            ((xx - cx) / (w / 2 - margin - 10)) ** 2 <= 1
        frames[i][blob] = 60
        frames[i] = np.clip(frames[i].astype(int) + rng.integers(0, 40, (h, w)) * blob,
                            0, 255).astype('uint8')
    assert not frames[:, :margin].any() and not frames[:, -margin:].any()
    assert not frames[:, :, :margin].any() and not frames[:, :, -margin:].any()
    return frames


def test_ellipse_is_cv2_element():
    ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (9, 9))
    np.testing.assert_array_equal(morphology.ELLIPSE_9X9, ref)
    assert morphology.ELLIPSE_9X9.sum() == 57


@pytest.mark.parametrize('shape', [(2, 40, 56), (1, 77, 101), (2, 160, 160)])
def test_plain_bit_exact_vs_pallas_interpret_on_arbitrary_frames(shape):
    rng = np.random.default_rng(sum(shape))
    frames = rng.integers(0, 256, shape).astype('uint8')
    frames[0, :3] = 255                       # a bright border
    ours = clean_kernel.clean_frames_plain(torch.from_numpy(frames))
    ref = np.asarray(jax_fused(jnp.asarray(frames), interpret=True))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_plain_bit_exact_vs_ops_path_on_zero_bordered_frames():
    frames = blob_frames(np.random.default_rng(0))
    ours = clean_kernel.clean_frames_plain(torch.from_numpy(frames))
    ref = np.asarray(jax_clean(frames, iters_tail=3))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ours.numpy().any()


def test_clean_frames_defaults_go_to_the_fused_clean():
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 64)).astype('uint8')
    before = clean_kernel.launch_count
    out = clean_frames(torch.from_numpy(frames))
    np.testing.assert_array_equal(
        out.numpy(), clean_kernel.clean_frames_plain(torch.from_numpy(frames)).numpy())
    assert clean_kernel.launch_count == before        # the CPU never launches


@pytest.mark.parametrize('kwargs', [
    dict(iters_tail=1), dict(iters_tail=2, iters_min=1), dict(prefilter_space=(1,), iters_tail=3),
    dict(prefilter_space=(3,), iters_tail=3, strel_tail=np.ones((3, 5), np.uint8)),
])
def test_clean_frames_ops_path_matches_jax(kwargs):
    '''Non-default parameters take the JAX package's cv2-border ops path; the
    port's morphology ops, composed in the same order, match it exactly on
    arbitrary frames.'''
    frames = np.random.default_rng(2).integers(0, 256, (2, 40, 52)).astype('uint8')
    ours = torch.from_numpy(frames)
    if kwargs.get('iters_min'):
        ours = morphology.erode(ours, np.ones((5, 5), np.uint8), kwargs['iters_min'])
    if 3 in kwargs.get('prefilter_space', (3,)):
        ours = morphology.median_blur_3x3(ours)
    ours = morphology.morph_open(ours, kwargs.get('strel_tail', morphology.ELLIPSE_9X9),
                                 kwargs['iters_tail'])
    ref = np.asarray(jax_clean(frames, **kwargs))
    np.testing.assert_array_equal(ours.numpy(), ref)


def _minimal_clean(frame):
    '''The form whose min/max operations ``chip_smoke.py`` counts for the
    clean's bound, on one zero-padded frame; returns (result, ops per pixel).'''
    ops = [0]

    def f(op):
        def g(a, b):
            ops[0] += 1
            return op(a, b)
        return g
    mn, mx = f(np.minimum), f(np.maximum)

    def sh(a, dy, dx):                       # a[y + dy, x + dx], zero outside
        out = np.zeros_like(a)
        h, w = a.shape
        out[max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
            a[max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)]
        return out

    def med3(a, b, c):
        return mx(mn(a, b), mn(mx(a, b), c))

    def ellipse(a, op):                      # rows of widths 1, 7, 7, 9, 9, 9, 7, 7, 1
        m2 = op(a, sh(a, 0, 1))
        m4 = op(m2, sh(m2, 0, 2))
        m7 = op(sh(m4, 0, -3), m4)
        m9 = op(op(sh(m4, 0, -4), m4), sh(a, 0, 4))
        v3 = op(op(sh(m9, -1, 0), m9), sh(m9, 1, 0))
        p7 = op(m7, sh(m7, 1, 0))
        ends = op(sh(a, -4, 0), sh(a, 4, 0))
        return op(op(v3, sh(p7, -3, 0)), op(sh(p7, 2, 0), ends))

    x = np.pad(frame, 30)
    lo1, hi1 = mn(sh(x, -1, 0), x), mx(sh(x, -1, 0), x)
    lo, mid0 = mn(lo1, sh(x, 1, 0)), mx(lo1, sh(x, 1, 0))
    mid, hi = mn(hi1, mid0), mx(hi1, mid0)
    x = med3(mx(mx(sh(lo, 0, -1), lo), sh(lo, 0, 1)), med3(sh(mid, 0, -1), mid, sh(mid, 0, 1)),
             mn(mn(sh(hi, 0, -1), hi), sh(hi, 0, 1)))
    for op in (mn,) * 3 + (mx,) * 3:
        x = ellipse(x, op)
    return x[30:-30, 30:-30], ops[0]


def test_bound_form_of_clean_matches_plain():
    '''The clean's bound in chip_smoke.py counts the operations of a form of
    the function; that form computes the function, bit for bit.'''
    import chip_smoke
    frame = np.random.default_rng(4).integers(0, 256, (45, 61)).astype('uint8')
    frame[:2] = 255                           # a bright border
    got, ops = _minimal_clean(frame)
    ref = clean_kernel.clean_frames_plain(torch.from_numpy(frame[None]))[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert ops == chip_smoke.CLEAN_OPS_PER_PIXEL


@pytest.mark.parametrize('op', ['erode', 'dilate', 'morph_open'])
@pytest.mark.parametrize('iterations', [1, 2])
def test_morphology_matches_jax(op, iterations):
    frames = np.random.default_rng(iterations).integers(0, 256, (2, 30, 41)).astype('uint8')
    strel = morphology.ELLIPSE_9X9
    ours = getattr(morphology, op)(torch.from_numpy(frames), strel, iterations)
    ref = getattr(jmorph, op)(jnp.asarray(frames), strel, iterations)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_median_matches_jax():
    frames = np.random.default_rng(3).integers(0, 256, (2, 30, 41)).astype('uint8')
    ours = morphology.median_blur_3x3(torch.from_numpy(frames))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jmorph.median_blur_3x3(jnp.asarray(frames))))


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        clean_kernel.clean_frames_cuda(torch.zeros((1, 8, 8), dtype=torch.uint8))


# The CUDA kernel's geometry and arithmetic (csrc/clean.cu), mirrored in
# numpy: frames packed in pairs into the two 16-bit lanes of uint32 words,
# the tiles of clean_kernel.tile_plan, the seven passes over their shrinking
# margins in groups of 4 words, three-input lane-wise min/max and the median
# of three as the sum less min and max.

KERNEL_SHAPES = [(64, 160, 160), (3, 77, 101), (2, 424, 512)]


def _blocks(plan, n, h, w):
    '''(n0, has_second, r0, c0, th, tw) of each block, as the kernel derives
    them from blockIdx.x.'''
    for blk in range(plan.blocks):
        tx = blk % plan.tiles_x
        rest = blk // plan.tiles_x
        ty = rest % plan.tiles_y
        n0 = 2 * (rest // plan.tiles_y)
        r0, c0 = ty * plan.tile_h, tx * plan.tile_w
        yield n0, n0 + 1 < n, r0, c0, min(plan.tile_h, h - r0), min(plan.tile_w, w - c0)


@pytest.mark.parametrize('shape', KERNEL_SHAPES)
def test_clean_tile_plan_covers_each_pixel_once(shape):
    n, h, w = shape
    plan = clean_kernel.tile_plan(n, h, w)
    assert plan.smem_bytes == clean_kernel.smem_bytes(plan.tile_h, plan.tile_w)
    assert plan.smem_bytes == 2 * (plan.tile_h + 50) * (plan.tile_w + 64) * 4
    assert plan.smem_bytes <= clean_kernel.MAX_SMEM == 232448
    assert plan.tile_w % 16 == 0 and clean_kernel.PAD_COLS >= clean_kernel.HALO == 25
    assert plan.blocks == plan.pairs * plan.tiles_y * plan.tiles_x
    assert plan.pairs == (n + 1) // 2
    count = np.zeros(shape, np.int32)
    for n0, second, r0, c0, th, tw in _blocks(plan, n, h, w):
        assert th >= 1 and tw >= 1
        count[n0, r0:r0 + th, c0:c0 + tw] += 1
        if second:
            count[n0 + 1, r0:r0 + th, c0:c0 + tw] += 1
    assert (count == 1).all()
    if shape == (64, 160, 160):
        # the main path's plan, as the kernel's source note states it
        assert (plan.tile_h, plan.tile_w, plan.blocks) == (80, 80, 128)


def _lanes(op):
    def f(a, b, c):
        lo = op(op(a & 0xFFFF, b & 0xFFFF), c & 0xFFFF)
        hi = op(op(a >> 16, b >> 16), c >> 16)
        return (lo | (hi << 16)).astype(np.uint32)
    return f


_vmin3, _vmax3 = _lanes(np.minimum), _lanes(np.maximum)


def _med3(a, b, c):
    return (a + b + c - _vmin3(a, b, c) - _vmax3(a, b, c)).astype(np.uint32)


def _median_region(src, r_lo, r_hi, c_lo, c_hi):
    '''median_pass: vertical triples sorted per column, then med3 of the
    max3 of lows, med3 of mids and min3 of highs across 3 columns.'''
    rows = [src[r_lo + d:r_hi + d, c_lo - 1:c_hi + 1] for d in (-1, 0, 1)]
    lo, hi = _vmin3(*rows), _vmax3(*rows)
    md = (rows[0] + rows[1] + rows[2] - lo - hi).astype(np.uint32)
    cols = lambda a: (a[:, :-2], a[:, 1:-1], a[:, 2:])
    return _med3(_vmax3(*cols(lo)), _med3(*cols(md)), _vmin3(*cols(hi)))


def _morph_region(src, r_lo, r_hi, c_lo, c_hi, op3):
    '''morph_pass: row extrema of widths 1, 7, 9, then the ellipse's rows
    h1, h7, h7, h9, h9, h9, h7, h7, h1 in the kernel's grouping.'''
    band = src[r_lo - 4:r_hi + 4]
    s = {d: band[:, c_lo + d:c_hi + d] for d in range(-4, 5)}
    h1 = s[0]
    h7 = op3(op3(s[-3], s[-2], s[-1]), s[0], op3(s[1], s[2], s[3]))
    h9 = op3(h7, s[-4], s[4])
    n = r_hi - r_lo
    row = lambda a, d: a[4 + d:4 + d + n]
    return op3(op3(row(h1, -4), row(h1, 4), row(h7, -3)),
               op3(row(h7, -2), row(h7, 2), row(h7, 3)),
               op3(row(h9, -1), row(h9, 0), row(h9, 1)))


def _kernel_mirror(frames, plan, rng):
    n, h, w = frames.shape
    out = np.zeros_like(frames)
    pitch = plan.tile_w + 64
    for n0, second, r0, c0, th, tw in _blocks(plan, n, h, w):
        # unstaged words hold whatever shared memory held: any 32-bit value
        a = rng.integers(0, 2 ** 32, (plan.tile_h + 50, pitch), dtype=np.uint32)
        b = rng.integers(0, 2 ** 32, a.shape, dtype=np.uint32)
        padded = np.zeros((2, h + 50, w + 64 + pitch), np.uint32)
        padded[0, 25:25 + h, 32:32 + w] = frames[n0]
        if second:
            padded[1, 25:25 + h, 32:32 + w] = frames[n0 + 1]
        rows = th + 50
        win = padded[:, r0:r0 + rows, c0:c0 + pitch]
        a[:rows] = win[0] | (win[1] << 16)
        bufs = [a, b]
        for k, m in enumerate(clean_kernel.MARGINS):
            src, dst = bufs[k % 2], bufs[(k + 1) % 2]
            r_lo, r_hi = 25 - m, 25 + th + m
            c_lo = 32 - m
            c_hi = c_lo + -(-(tw + 2 * m) // 4) * 4
            if k == 0:
                res = _median_region(src, r_lo, r_hi, c_lo, c_hi)
            else:
                res = _morph_region(src, r_lo, r_hi, c_lo, c_hi, _vmin3 if k <= 3 else _vmax3)
            dst[r_lo:r_hi, c_lo:c_hi] = res
        res = dst[25:25 + th, 32:32 + tw]
        out[n0, r0:r0 + th, c0:c0 + tw] = res & 0xFF
        if second:
            out[n0 + 1, r0:r0 + th, c0:c0 + tw] = res >> 16
    return out


@pytest.mark.parametrize('shape,plan_shape', [
    ((4, 160, 160), (64, 160, 160)),      # the main path's tiles, on 4 frames
    ((3, 77, 101), (3, 77, 101)),         # an odd frame count, ragged tiles
    ((2, 45, 61), (2, 45, 61)),
])
def test_packed_kernel_mirror_bit_exact_vs_plain(shape, plan_shape):
    rng = np.random.default_rng(sum(shape))
    frames = rng.integers(0, 256, shape).astype('uint8')
    frames[0, :3] = 255                       # a bright border
    plan = clean_kernel.tile_plan(*plan_shape)
    got = _kernel_mirror(frames, plan._replace(
        pairs=(shape[0] + 1) // 2, blocks=(shape[0] + 1) // 2 * plan.tiles_y * plan.tiles_x),
        rng)
    ref = clean_kernel.clean_frames_plain(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_packed_lane_median_never_carries():
    '''med3 as the sum less min3 and max3 is exact lane by lane for every
    pair of 8-bit values in the two 16-bit lanes.'''
    rng = np.random.default_rng(5)
    a, b, c = (rng.integers(0, 256, (3, 4096)).astype(np.uint32) for _ in range(3))
    words = [x[0] | (x[1] << 16) for x in (a, b, c)]
    words = [np.concatenate([w, np.array([255 | 255 << 16, 0, 255], np.uint32)]) for w in words]
    got = _med3(*words)
    for lane in (0, 16):
        vals = np.stack([(w >> lane) & 0xFFFF for w in words])
        np.testing.assert_array_equal((got >> lane) & 0xFFFF, np.median(vals, axis=0))
