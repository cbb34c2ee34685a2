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
from moseq2_detectron_extract_tpu_torch.ops.roi_align import (assign_fpn_levels,
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
