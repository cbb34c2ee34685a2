'''ROIAlign: the port's plain version against the JAX package's separable
formulation (f32) and its Pallas kernel in interpret mode (bf16), and the
CPU dispatch of the kernel wrapper (the kernel itself: test_torch_cuda).

Tolerances. At f32 the two separable formulations are the same algebra in
another summation order (sums of up to 75 rows and 40 columns): 5e-5
absolute on unit-scale features. Against the Pallas kernel, which rounds its
interpolation weights and its stage-1 intermediate to bf16 and returns bf16,
while the port computes in f32 and rounds once: 2 bf16 ulps, i.e. 2**-6
relative plus 2**-6 absolute.
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
    keypoint out=7, K=1) at a narrow width.'''
    feats, boxes = random_pyramid(b=2, k=k, c=8, seed=10 + out + k)
    feats = [_bf16_f32(f) for f in feats]
    ref = pallas_separable_roi_align(
        tuple(jnp.asarray(f, jnp.bfloat16) for f in feats), jnp.asarray(boxes), out,
        interpret=True, out_dtype=jnp.bfloat16)
    ours = roi_align_kernel.roi_align([torch.from_numpy(f) for f in feats],
                                      torch.from_numpy(boxes), out)
    assert ours.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=BF16_TOL, atol=BF16_TOL)


def test_cpu_dispatch_uses_plain_version_without_launching():
    feats, boxes = random_pyramid(seed=3)
    before = roi_align_kernel.launch_count
    out = roi_align_kernel.roi_align([torch.from_numpy(f) for f in feats],
                                     torch.from_numpy(boxes), 7)
    plain = separable_batched_roi_align([torch.from_numpy(f) for f in feats],
                                        torch.from_numpy(boxes), 7,
                                        out_dtype=torch.bfloat16)
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


def _warp_walk(feats, boxes, out, segs):
    '''The kernel's form in f32, and per (ROI, row, segment) the columns its
    walk interpolated, in order.'''
    b, k = boxes.shape[:2]
    sizes = [f.shape[1:3] for f in feats]
    flat = torch.from_numpy(boxes).reshape(-1, 4)
    lvl, ((y0, y1, fy), (x0, x1, fx)) = _sample_taps(flat, sizes, out)
    res = np.zeros((b * k, out, out, feats[0].shape[-1]), np.float32)
    walks = {}
    half = np.float32(0.5)
    for r in range(b * k):
        level = feats[int(lvl[r])][r // k]
        for oy in range(out):
            pairs = []
            for i in (2 * oy, 2 * oy + 1):
                f = np.float32(fy[r, i])
                pairs += [(int(y0[r, i]), half * (1 - f)), (int(y1[r, i]), half * f)]
            for begin, end in segments(out, segs):
                cache, walked = {}, []
                for ox in range(begin, end):
                    for j in (2 * ox, 2 * ox + 1):
                        taps = []
                        for x in (int(x0[r, j]), int(x1[r, j])):
                            if x not in cache:
                                cache = {key: val for key, val in cache.items()
                                         if key == (walked[-1] if walked else None)}
                                cache[x] = sum(w * level[row, x] for row, w in pairs)
                                walked.append(x)
                            taps.append(cache[x])
                        f = np.float32(fx[r, j])
                        res[r, oy, ox] += half * ((1 - f) * taps[0] + f * taps[1])
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
    '''f32 against f32: the same sums in another order, 1e-5 on unit-scale
    features.'''
    for feats, boxes in _pyramid_cases():
        got, _ = _warp_walk(feats, boxes, out, segs)
        ref = separable_batched_roi_align([torch.from_numpy(f) for f in feats],
                                          torch.from_numpy(boxes), out)
        np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('rois,c,out,vec,segs,warps', [
    (256, 256, 7, 8, 1, 1792),     # box stage: B 16, K 16
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
