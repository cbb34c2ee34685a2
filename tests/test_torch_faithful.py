'''The faithful model's shapes (``benchmarks/bench_model/config.yaml``: a
256-px canvas, frames scaled to 240-250 px, 1,000 pre-NMS proposals a
level, a global NMS cap of 1,024 and 256 proposals an image) through the
port and the JAX package on the CPU, at narrow widths (the tiny model of
``tiny_jax_config``: one block per stage, width 16, FPN 64, f32).

Tolerances. The Predictor: the same valid detections and selection
(``keep``). Both packages pool in bf16 at inference (bf16 weights and T),
so a box that f32 sums in another order move (1.2e-4 relative on these
frames, the random weights' box regression amplifying them) moves pooled
values across bf16 rounding edges, and the heads' outputs are held at
that level, as ``test_torch_slice`` holds the slice, with what these
frames read in brackets: boxes and keypoints 0.05 px at frame scale
(0.015, 0.013), keypoint scores 1e-4 (3.7e-5), scores 1e-3 (7.0e-5), mask
probabilities 1e-2 (3.0e-3); a mask pixel whose resized probability lies
that close to 0.5 may flip, at most 1% of each mask (3 of 518 pixels on
these frames). The NMS keep masks are equal. The plain ROIAlign: 5e-5 in
f32 as ``test_torch_roi_align`` holds it; on bf16 levels by
``chip_smoke.py``'s rule for the kernel (every element within 2 bf16 ulps
of its magnitude, at most 0.2% of them off and 0.1% two ulps or more).
With 256 ROIs an image some outputs nearly cancel: a T value rounded to
the other bf16 neighbour moves such an output by many of its own ulps but
by less than 2^-6 absolute (read on these inputs at the box stage: 0.085%
off, 0.029% by two ulps or more, 2^-7 at most; the mask stage's one ROI an
image is equal).
'''
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moseq2_detectron_extract_tpu.models.predictor import Predictor as JaxPredictor
from moseq2_detectron_extract_tpu.ops import nms as jnms
from moseq2_detectron_extract_tpu.ops.roi_align import separable_batched_roi_align as jax_sep
from moseq2_detectron_extract_tpu_torch.models.train import create_train_state
from moseq2_detectron_extract_tpu_torch.models.weights import params_to_jax
from moseq2_detectron_extract_tpu_torch.ops import nms
from moseq2_detectron_extract_tpu_torch.ops.roi_align import separable_batched_roi_align
from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk

from tests.test_torch_common import jax_tree, port_config, port_predictor, tiny_jax_config
from tests.test_torch_cuda import chain_of_boxes
from tests.test_torch_roi_align import BF16_TOL, bf16_ulps, random_pyramid

# the fields in which benchmarks/bench_model/config.yaml differs from fast160's
FAITHFUL = {'image_size': 256, 'min_size_test': 240, 'max_size_test': 250,
            'rpn_pre_nms_topk_test': 1000, 'rpn_post_nms_topk_test': 256,
            'rpn_nms_global_cap': 1024, 'test_detections_per_image': 1}
FRAME = (212, 256)          # half a Kinect frame: scaled to 207 x 250 on the canvas
CHAIN = 100                 # boxes in a chain of suppressions: 50 rounds to decide


def faithful_params(cfg, seed: int = 0):
    '''flax-default weights made by the port (``create_train_state``) with
    random FrozenBN statistics, as the flat npz keys and as the JAX tree:
    the JAX package's own init compiles for seconds.'''
    state = create_train_state(port_config(cfg), seed=seed, device='cpu').model.state_dict()
    flat = params_to_jax(state, cfg.box_pooler_resolution)
    rng = np.random.default_rng(seed)
    for key in sorted(flat):
        if 'FrozenBatchNorm' in key:
            low, high = {'scale': (0.5, 1.5), 'bias': (-0.2, 0.2), 'mean': (-0.2, 0.2),
                         'var': (0.5, 1.5)}[key.rsplit('/', 1)[1]]
            flat[key] = rng.uniform(low, high, flat[key].shape).astype('float32')
    return flat, jax_tree(flat)


@pytest.fixture(scope='module')
def both():
    cfg = tiny_jax_config(test_score_thresh=0.0, **FAITHFUL)
    flat, tree = faithful_params(cfg)
    chunk = make_sentinel_chunk(2, *FRAME, seed=4)
    frames = np.where(chunk == 255, 0, chunk).astype(np.uint8)
    nms.sync_count = 0
    ours = port_predictor(cfg, flat, batch_size=2)(torch.from_numpy(frames))
    syncs = nms.sync_count
    ref = JaxPredictor(cfg, tree, batch_size=2)(frames, select=True)
    return ours, ref, syncs


def test_predictor_matches_jax_at_faithful_shapes(both):
    ours, ref, syncs = both
    ours = {k: v.numpy() for k, v in ours.items()}
    assert ours['masks'].shape == (2, 1) + FRAME
    for key in ('valid', 'keep', 'classes'):
        np.testing.assert_array_equal(ours[key], ref[key])
    assert ours['valid'].all()
    whole = slice(None)
    for key, part, tol in (('boxes', whole, 0.05), ('keypoints', slice(0, 2), 0.05),
                           ('keypoints', 2, 1e-4), ('scores', whole, 1e-3),
                           ('mask_probs', whole, 1e-2)):
        np.testing.assert_allclose(ours[key][..., part], ref[key][..., part], rtol=0,
                                   atol=tol, err_msg=key)
    flips = (ours['masks'] != ref['masks']).sum(axis=(2, 3))
    assert (ref['masks'].sum(axis=(2, 3)) > 100).all()
    assert (flips <= 0.01 * ref['masks'].sum(axis=(2, 3))).all(), flips
    # one proposal NMS of the (2, 1024, 1024) pool per batch, each round
    # asking the host once, within the 32-round cap
    assert 1 <= syncs <= nms.MAX_ITERS


@pytest.mark.parametrize('batched', [False, True])
def test_nms_at_the_global_cap_with_the_round_cut(batched):
    '''K = 1,024 as the faithful model's proposal NMS sees it, with a chain
    of suppressions longer than the 32 rounds both packages stop at: the
    keep masks are equal, cut where both loops are cut.'''
    rng = np.random.default_rng(21)
    cases = [chain_of_boxes(rng, 1024, CHAIN) for _ in range(2)]
    boxes, scores, levels, valid = (np.stack(parts) for parts in zip(*cases))
    args = (torch.from_numpy(boxes), torch.from_numpy(scores))
    nms.sync_count = 0
    if batched:
        ours = nms.batched_nms_keep_mask(*args, torch.from_numpy(levels), 0.7,
                                         valid=torch.from_numpy(valid)).numpy()
    else:
        ours = nms.nms_keep_mask(*args, 0.7, valid=torch.from_numpy(valid)).numpy()
    assert nms.sync_count == nms.MAX_ITERS          # the loop ran to its cap
    for i in range(2):
        jargs = (jnp.asarray(boxes[i]), jnp.asarray(scores[i]))
        if batched:
            ref = jnms.batched_nms_keep_mask(*jargs, jnp.asarray(levels[i]), 0.7,
                                             valid=jnp.asarray(valid[i]))
        else:
            ref = jnms.nms_keep_mask(*jargs, 0.7, valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(ours[i], np.asarray(ref))
    # 32 rounds decide the chain's first 64 boxes (every other one kept) and
    # leave the rest undecided, so not kept, where greedy NMS would keep them
    chain = ours[:, :CHAIN]
    assert (chain[:, :2 * nms.MAX_ITERS:2]).all() and not chain[:, 1:2 * nms.MAX_ITERS:2].any()
    assert not chain[:, 2 * nms.MAX_ITERS:].any()


@pytest.mark.parametrize('out,k', [(7, 256), (14, 1)])
def test_plain_roi_align_at_faithful_shapes(out, k):
    '''The box stage's 256 ROIs an image and the mask stage's one on the
    256 canvas (P2..P5 of 64, 32, 16 and 8 px) at C 8: the plain version
    against the JAX separable form in f32, and on bf16 levels as the
    inference pooling rounds.'''
    feats, boxes = random_pyramid(b=2, k=k, c=8, canvas=256, seed=300 + out)
    assert [f.shape[1] for f in feats] == [64, 32, 16, 8]
    import jax
    ours = separable_batched_roi_align([torch.from_numpy(f) for f in feats],
                                       torch.from_numpy(boxes), out)
    ref = jax_sep(tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes), out,
                  precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-5)
    levels = [torch.from_numpy(f).to(torch.bfloat16) for f in feats]
    ours = separable_batched_roi_align(levels, torch.from_numpy(boxes), out)
    ref = jax_sep(tuple(jnp.asarray(f, jnp.bfloat16) for f in feats), jnp.asarray(boxes),
                  out).astype(jnp.bfloat16)
    ours, ref = ours.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert (np.abs(ours - ref) <= BF16_TOL * (1 + np.abs(ref))).all()
    ulps = bf16_ulps(ours, ref)
    assert (ulps >= 1).sum() <= 2e-3 * ulps.size and (ulps >= 2).sum() <= 1e-3 * ulps.size
