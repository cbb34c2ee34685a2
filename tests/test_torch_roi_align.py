'''ROIAlign: the port's plain version against the JAX package's separable
formulation (f32) and its Pallas kernel in interpret mode (bf16), and the
CPU dispatch of the kernel wrapper (the kernel itself: test_torch_cuda).

Tolerances. At f32 the two separable formulations are the same algebra in
another summation order (sums of up to 75 rows and 40 columns): 5e-5
absolute on unit-scale features. On bf16 features both packages fold the
weights in f32 and round them to bf16, round the stage-1 product T to bf16
and the output once; every product is exact in f32 and only the order of
the f32 sums differs. A T value on a bf16 rounding edge may land on the
other neighbour, and reaches an output through at most four x taps: so an
output may be one bf16 ulp off, a stated number of outputs two ulps, and
none further (``bf16_ulps``).
'''
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moseq2_detectron_extract_tpu.ops.pallas_roi_align import pallas_separable_roi_align
from moseq2_detectron_extract_tpu.ops.roi_align import (assign_fpn_levels as jax_levels,
                                                        separable_batched_roi_align as jax_sep)
from moseq2_detectron_extract_tpu_torch.ops import roi_align_kernel
from moseq2_detectron_extract_tpu_torch.ops.roi_align import (_roi_sample_coords,
                                                              assign_fpn_levels,
                                                              separable_batched_roi_align)

BF16_TOL = 2.0 ** -6


def random_pyramid(b=2, k=9, c=16, canvas=160, seed=0):
    '''Levels P2..P5 NHWC and (B, K, 4) boxes across all levels, some past
    the canvas edge (clamped samples) and some degenerate.'''
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 1, (b, canvas // (4 * 2 ** l), canvas // (4 * 2 ** l), c))
             .astype('float32') for l in range(4)]
    cx = rng.uniform(-10, canvas + 10, (b, k))
    cy = rng.uniform(-10, canvas + 10, (b, k))
    wh = rng.uniform(2, 1.5 * canvas, (b, k, 2))
    boxes = np.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                      cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], -1).astype('float32')
    boxes[0, 0] = [30.0, 30.0, 30.0, 30.0]
    return feats, boxes


def _bf16_f32(x):
    '''Round to bf16 and back, in numpy via torch.'''
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def bf16_ulps(a, b):
    '''Distance in bf16 steps between two arrays of bf16 values (given in
    any float dtype): the ordered integer codes' difference.'''
    def code(x):
        bits = torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16) \
            .view(torch.int16).numpy().astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7fff), bits)
    return np.abs(code(a) - code(b))


def assert_bf16_close(ours, ref, two_ulps):
    '''At most one bf16 ulp off, save exactly ``two_ulps`` elements two ulps
    off (the count read on these inputs), and none further.'''
    ulps = bf16_ulps(ours, ref)
    assert ulps.max() <= 2, ulps.max()
    assert int((ulps == 2).sum()) == two_ulps, (int((ulps == 2).sum()), int((ulps == 1).sum()))
    return ulps


def test_levels_match():
    _, boxes = random_pyramid(k=64, seed=1)
    flat = boxes.reshape(-1, 4)
    np.testing.assert_array_equal(assign_fpn_levels(torch.from_numpy(flat)).numpy(),
                                  np.asarray(jax_levels(jnp.asarray(flat))))


@pytest.mark.parametrize('out', [7, 14])
def test_plain_matches_jax_separable_f32(out):
    feats, boxes = random_pyramid(seed=out)
    ours = separable_batched_roi_align([torch.from_numpy(f) for f in feats],
                                       torch.from_numpy(boxes), out)
    import jax
    ref = jax_sep(tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes), out,
                  precision=jax.lax.Precision.HIGHEST)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-5)


@pytest.mark.parametrize('out,k', [(7, 16), (14, 1), (7, 1)])
def test_plain_matches_pallas_kernel_interpret_bf16(out, k):
    '''The main path's three stages (box out=7, K=16; mask out=14, K=1;
    keypoint out=7, K=1) at a narrow width, through the kernel wrapper's CPU
    dispatch: one bf16 ulp, no element two ulps off on these inputs.'''
    feats, boxes = random_pyramid(b=2, k=k, c=8, seed=10 + out + k)
    feats = [_bf16_f32(f) for f in feats]
    ref = pallas_separable_roi_align(
        tuple(jnp.asarray(f, jnp.bfloat16) for f in feats), jnp.asarray(boxes), out,
        interpret=True, out_dtype=jnp.bfloat16)
    ours = roi_align_kernel.roi_align([torch.from_numpy(f) for f in feats],
                                      torch.from_numpy(boxes), out)
    assert ours.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert_bf16_close(ours.float().numpy(), ref, two_ulps=0)
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=BF16_TOL, atol=BF16_TOL)


# (out, K, C, seed) -> elements two bf16 ulps off the JAX separable form
BF16_CASES = {(7, 16, 32, 0): 0, (14, 1, 32, 1): 0, (7, 1, 32, 2): 0, (7, 9, 16, 3): 0}


@pytest.mark.parametrize('out,k,c,seed', list(BF16_CASES))
def test_plain_bf16_rounds_as_jax_separable(out, k, c, seed):
    '''The plain version on bf16 levels against JAX's
    ``separable_batched_roi_align`` on the same bf16 levels (its inference
    pooling off the TPU): bf16 out, at most one ulp off save the stated count
    of two-ulp elements. Most elements are equal.'''
    feats, boxes = random_pyramid(b=2, k=k, c=c, seed=100 + seed)
    levels = [torch.from_numpy(f).to(torch.bfloat16) for f in feats]
    ours = separable_batched_roi_align(levels, torch.from_numpy(boxes), out)
    assert ours.dtype == torch.bfloat16
    # its output is f32; the inference entry rounds it to bf16 once
    ref = jax_sep(tuple(jnp.asarray(f, jnp.bfloat16) for f in feats), jnp.asarray(boxes),
                  out).astype(jnp.bfloat16)
    ulps = assert_bf16_close(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                             BF16_CASES[out, k, c, seed])
    assert (ulps == 0).mean() >= 0.99


def test_plain_bf16_weights_and_t_are_bf16():
    '''The bf16 path is not the f32 path rounded once: on these inputs the two
    differ, and the bf16 path equals the f32 algebra run on bf16-rounded
    weights with T rounded to bf16.'''
    from moseq2_detectron_extract_tpu_torch.ops.roi_align import _separable_inputs
    feats, boxes = random_pyramid(b=1, k=6, c=16, seed=7)
    levels = [torch.from_numpy(f).to(torch.bfloat16) for f in feats]
    tb = torch.from_numpy(boxes)
    ours = separable_batched_roi_align(levels, tb, 7)
    once = separable_batched_roi_align([f.float() for f in levels], tb, 7,
                                       out_dtype=torch.bfloat16)
    assert not torch.equal(ours, once)
    f_stack, wy, wx = _separable_inputs(levels, tb, 7, 2, as_dtype=torch.bfloat16)
    t = torch.einsum('bkyh,bhwc->bkywc', wy.float(), f_stack.float()).to(torch.bfloat16)
    ref = torch.einsum('bkxw,bkywc->bkyxc', wx.float(), t.float()).to(torch.bfloat16)
    assert torch.equal(ours, ref)


def test_cpu_dispatch_uses_plain_version_without_launching():
    feats, boxes = random_pyramid(seed=3)
    before = roi_align_kernel.launch_count
    out = roi_align_kernel.roi_align([torch.from_numpy(f) for f in feats],
                                     torch.from_numpy(boxes), 7)
    plain = separable_batched_roi_align([torch.from_numpy(f).to(torch.bfloat16)
                                         for f in feats],
                                        torch.from_numpy(boxes), 7)
    assert torch.equal(out, plain)
    assert roi_align_kernel.launch_count == before


def test_kernel_wrapper_refuses_cpu_tensors():
    feats, boxes = random_pyramid(seed=4)
    with pytest.raises(ValueError):
        roi_align_kernel.roi_align_cuda(
            [torch.from_numpy(f).to(torch.bfloat16) for f in feats],
            torch.from_numpy(boxes), 7)


# The CUDA kernel's geometry (csrc/roi_align.cu), mirrored: one warp per
# (ROI, output row, segment of its columns), the row's two y samples as 4
# (row, weight) pairs, and a walk along the x samples that interpolates
# each column it touches along y once, keeping the last two columns.

def whole_level_case(level, c=8, seed=0):
    '''A pyramid whose canvas makes the full-canvas box fall on ``level``,
    with that box, one past the canvas on every side and a small one.'''
    canvas = 100 * 2 ** (level - 2)
    rng = np.random.default_rng(seed + level)
    feats = [rng.normal(0, 1, (1, canvas // 2 ** l, canvas // 2 ** l, c)).astype('float32')
             for l in (2, 3, 4, 5)]
    boxes = np.array([[[0, 0, canvas, canvas],
                       [-canvas / 8, -canvas / 10, canvas * 1.1, canvas * 1.05],
                       [canvas / 3, canvas / 4, canvas / 3 + 9, canvas / 4 + 13]]], 'float32')
    return feats, boxes


def _sample_taps(boxes, sizes, out):
    '''Per ROI: the level, and c0, c1, frac of every y and x sample, as
    sample_coord computes them.'''
    lvl = assign_fpn_levels(boxes).long() - 2
    ys, xs = _roi_sample_coords(boxes, out, (2.0 ** (lvl + 2)).float())
    taps = []
    for coords, axis in ((ys, 0), (xs, 1)):
        size = torch.tensor([sizes[l][axis] for l in lvl.tolist()])[:, None]
        cs = torch.minimum(coords.clamp(min=0.0), (size - 1).float())
        c0 = cs.floor()
        taps.append((c0.long(), torch.minimum(c0.long() + 1, size - 1), cs - c0))
    return lvl, taps


def _pyramid_cases():
    feats, boxes = random_pyramid(b=2, k=9, c=8, seed=21)
    yield feats, boxes
    for level in (2, 3, 4, 5):
        yield whole_level_case(level)


def segments(output_size, segs):
    '''The [begin, end) output columns of each segment, as the kernel cuts
    a row (ceil(out / segs) columns each); empty segments, whose warps
    return at once, are left out.'''
    per = -(-output_size // segs)
    return [(b, min(output_size, b + per)) for b in range(0, output_size, per)]


def _round_bf16(x):
    '''f32 values rounded to the nearest bf16 (ties to even), as f32.'''
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7fff + ((bits >> 16) & 1)) & 0xffff0000
    return bits.astype(np.uint32).view(np.float32)


def _fold_taps(taps, fa, fb):
    '''The kernel's fold_taps: each of the four taps' folded weight in f32,
    rounded to bf16, 0 for a tap whose row an earlier tap holds.'''
    zero, half = np.float32(0), np.float32(0.5)
    ga, gb = np.float32(1) - fa, np.float32(1) - fb
    weights = []
    for e, h in enumerate(taps):
        wa = (ga if taps[0] == h else zero) + (fa if taps[1] == h else zero)
        wb = (gb if taps[2] == h else zero) + (fb if taps[3] == h else zero)
        weights.append(zero if h in taps[:e] else _round_bf16(half * (wa + wb)))
    return weights


def _warp_walk(feats, boxes, out, segs):
    '''The kernel's form on the bf16-rounded levels, and per (ROI, row,
    segment) the columns its walk interpolated, in order.'''
    b, k = boxes.shape[:2]
    sizes = [f.shape[1:3] for f in feats]
    feats = [_round_bf16(f) for f in feats]
    flat = torch.from_numpy(boxes).reshape(-1, 4)
    lvl, ((y0, y1, fy), (x0, x1, fx)) = _sample_taps(flat, sizes, out)
    res = np.zeros((b * k, out, out, feats[0].shape[-1]), np.float32)
    walks = {}
    for r in range(b * k):
        level = feats[int(lvl[r])][r // k]
        for oy in range(out):
            rows = [int(v) for i in (2 * oy, 2 * oy + 1) for v in (y0[r, i], y1[r, i])]
            wy = _fold_taps(rows, np.float32(fy[r, 2 * oy]), np.float32(fy[r, 2 * oy + 1]))
            for begin, end in segments(out, segs):
                cache, walked = {}, []
                for ox in range(begin, end):
                    cols = [int(v) for j in (2 * ox, 2 * ox + 1) for v in (x0[r, j], x1[r, j])]
                    wx = _fold_taps(cols, np.float32(fx[r, 2 * ox]),
                                    np.float32(fx[r, 2 * ox + 1]))
                    acc = np.zeros(level.shape[-1], np.float32)
                    for x, w in zip(cols, wx):
                        if x not in cache:
                            cache = {key: val for key, val in cache.items()
                                     if key == (walked[-1] if walked else None)}
                            t = np.zeros(level.shape[-1], np.float32)
                            for row, v in zip(rows, wy):
                                t += v * level[row, x]
                            cache[x] = _round_bf16(t)
                            walked.append(x)
                        acc += w * cache[x]
                    res[r, oy, ox] = _round_bf16(acc)
                walks[r, oy, begin] = walked
    return res.reshape(b, k, out, out, -1), walks


@pytest.mark.parametrize('out', [7, 14])
def test_roi_rows_and_columns_each_warp_reads(out):
    '''Each warp reads its row's 4 sample rows; its walk interpolates each
    column its samples touch once (the samples are monotone along x), so the
    columns it reads number at most 2 per sample and at most the level's
    width, for boxes past the canvas and whole-level boxes at every level.'''
    seen_levels = set()
    for segs in (1, 2):
        for feats, boxes in _pyramid_cases():
            sizes = [f.shape[1:3] for f in feats]
            flat = torch.from_numpy(boxes).reshape(-1, 4)
            lvl, (_, (x0, x1, _)) = _sample_taps(flat, sizes, out)
            _, walks = _warp_walk(feats, boxes, out, segs)
            for (r, oy, begin), walked in walks.items():
                end = dict(segments(out, segs))[begin]
                touched = set(x0[r, 2 * begin:2 * end].tolist()) | \
                    set(x1[r, 2 * begin:2 * end].tolist())
                assert sorted(walked) == sorted(touched) == walked
                assert len(walked) <= min(4 * (end - begin), sizes[int(lvl[r])][1])
            seen_levels |= set(lvl.tolist())
            if boxes.shape[1] == 3 and boxes[0, 0, 2] > 0:
                # the full-canvas box's walk covers its whole level
                w = sizes[int(lvl[0])][1]
                cols = set().union(*(walks[0, 0, b] for b, _ in segments(out, segs)))
                assert min(cols) == 0 and max(cols) == w - 1
    assert seen_levels == {0, 1, 2, 3}


@pytest.mark.parametrize('out', [7, 14])
@pytest.mark.parametrize('segs', [1, 3])
def test_warp_walk_separable_matches_plain(out, segs):
    '''The kernel's form against the plain version on the same bf16 levels:
    the same bf16 weights and products, summed in another order, so at most
    one bf16 ulp off (none two ulps off on these inputs), nearly all equal.'''
    for feats, boxes in _pyramid_cases():
        got, _ = _warp_walk(feats, boxes, out, segs)
        ref = separable_batched_roi_align([torch.from_numpy(f).to(torch.bfloat16)
                                           for f in feats], torch.from_numpy(boxes), out)
        ulps = assert_bf16_close(got, ref.float().numpy(), two_ulps=0)
        assert (ulps == 0).mean() >= 0.99


@pytest.mark.parametrize('rois,c,out,vec,segs,warps', [
    (256, 256, 7, 8, 1, 1792),     # box stage: B 16, K 16
    (4096, 256, 7, 8, 1, 28672),   # the faithful model's box stage: B 16, K 256
    (16, 256, 14, 8, 5, 1120),     # mask stage: B 16, K 1, rows in 5 segments
    (16, 256, 7, 8, 7, 784),       # keypoint stage: a warp per output
    (12, 6, 5, 1, 5, 300),         # C = 6: one channel a lane
    (4, 16, 32, 8, 9, 1152),       # the largest output
    (12, 24, 7, 8, 7, 588),        # C a multiple of 8, not of 16
])
def test_roi_launch_plan(rois, c, out, vec, segs, warps):
    from moseq2_detectron_extract_tpu_torch.ops import roi_align_kernel as rk
    plan = rk.launch_plan(rois, c, out, vec)
    assert (plan.vec, plan.segs, plan.warps) == (vec, segs, warps)
    assert plan.groups * 32 * vec >= c and plan.segs <= out
    assert plan.warps >= min(rk.SMS * rk.WARPS_PER_SM, rois * out * out * plan.groups)
    cols = [x for b, e in segments(out, plan.segs) for x in range(b, e)]
    assert cols == list(range(out))                       # each column once
