'''The ROIAlign stage-2 experiment's four layouts: the port's plain version
against the JAX script's Pallas bodies (``benchmarks/roi_stage2_exp.py``, in
interpret mode), the launch plan and the kernels' inputs, the CPU dispatch,
the port's experiment entry, and the separable inputs in bf16 (the kernels
themselves: test_torch_cuda).

Tolerances. The plain version mirrors the bodies' rounding chain: the same
bf16 pyramid and weights, stage 1 summed in f32 and rounded to bf16, stage 2
summed in f32. Only the order of the f32 sums differs. So almost every
output agrees to about one f32 ulp: at least 99% of elements within 1e-6.
Where two stage-1 sums differ in the last bit, an element of T may round to
the other bf16 neighbour (one bf16 ulp of T) and move the outputs it feeds by
that times its x weight: every element within 2 bf16 ulps, 2**-6 relative
plus 2**-6 absolute, as the port's ROIAlign against the Pallas kernel
(measured: at most 1.0e-5, on 0.3% of elements). The separable inputs in
bf16 are bit-exact.
'''
import importlib.util
import os
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moseq2_detectron_extract_tpu.ops.roi_align import _separable_inputs as jax_separable_inputs
from moseq2_detectron_extract_tpu_torch.benchmarks import roi_stage2_exp as port_exp
from moseq2_detectron_extract_tpu_torch.ops import roi_stage2_kernel as rs
from moseq2_detectron_extract_tpu_torch.ops.roi_align import _separable_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = 2.0 ** -6
RUNS = [('retile', 'float32'), ('transpose', 'float32'), ('dotswap', 'float32'),
        ('noxpose', 'float32'), ('noxpose', 'bfloat16')]


@pytest.fixture(scope='module')
def jax_exp():
    '''The JAX script, loaded from its file without switching on its
    persistent compilation cache for the rest of this process.'''
    saved = os.environ.get('MOSEQ_NO_COMPILE_CACHE')
    os.environ['MOSEQ_NO_COMPILE_CACHE'] = '1'
    try:
        spec = importlib.util.spec_from_file_location(
            'jax_roi_stage2_exp', os.path.join(REPO, 'benchmarks', 'roi_stage2_exp.py'))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if saved is None:
            del os.environ['MOSEQ_NO_COMPILE_CACHE']
        else:
            os.environ['MOSEQ_NO_COMPILE_CACHE'] = saved
    return module


def _body(jax_exp, variant):
    return {'retile': jax_exp._kernel_retile_peroy, 'transpose': jax_exp._kernel_transpose,
            'dotswap': jax_exp._kernel_dotswap, 'noxpose': jax_exp._kernel_noxpose}[variant]


def _jax_run(jax_exp, variant, dtype, feats, boxes, block_k=8):
    impl = jax_exp.make_variant(_body(jax_exp, variant), block_k, getattr(jnp, dtype))
    return np.asarray(impl(feats, boxes, 7, interpret=True).astype(jnp.float32))


@pytest.mark.parametrize('variant,dtype', RUNS, ids=[f'{v}-{d}' for v, d in RUNS])
@pytest.mark.parametrize('b,k,seed', [(1, 8, 0), (2, 13, 1)])   # 13: not a multiple of 8
def test_plain_matches_jax_body(jax_exp, variant, dtype, b, k, seed):
    feats, boxes = jax_exp.make_inputs(b=b, k=k, c=128, canvas=256, seed=seed)
    ref = _jax_run(jax_exp, variant, dtype, feats, boxes)
    tf, tb = port_exp.make_inputs(b, k, 128, 256, seed=seed, device='cpu')
    ours = rs.roi_stage2(tf, tb, 7, variant, 8, getattr(torch, dtype))
    assert ours.dtype == getattr(torch, dtype)
    assert tuple(ours.shape) == ref.shape == ((b, k, 7, 128, 7) if variant == 'noxpose'
                                             else (b, k, 7, 7, 128))
    ours = ours.float().numpy()
    np.testing.assert_allclose(ours, ref, rtol=BF16_TOL, atol=BF16_TOL)
    assert np.mean(np.abs(ours - ref) <= 1e-6 * (1 + np.abs(ref))) >= 0.99


def test_noxpose_is_dotswap_permuted(jax_exp):
    '''Exactly, in the plain version and in the JAX bodies.'''
    tf, tb = port_exp.make_inputs(2, 11, 32, 256, seed=4, device='cpu')
    dot = rs.roi_stage2_plain(tf, tb, 7, 'dotswap', 8)
    nox = rs.roi_stage2_plain(tf, tb, 7, 'noxpose', 8)
    assert torch.equal(nox, dot.transpose(3, 4).contiguous())
    feats, boxes = jax_exp.make_inputs(b=2, k=11, c=32, canvas=256, seed=4)
    jdot = _jax_run(jax_exp, 'dotswap', 'float32', feats, boxes)
    jnox = _jax_run(jax_exp, 'noxpose', 'float32', feats, boxes)
    np.testing.assert_array_equal(jnox, jdot.transpose(0, 1, 2, 4, 3))


def test_plain_block_k_changes_nothing():
    '''The ROI padding is cut again: block_k 8 and 16 give the same result.'''
    tf, tb = port_exp.make_inputs(1, 21, 16, 128, seed=5, device='cpu')
    for variant in rs.VARIANTS:
        assert torch.equal(rs.roi_stage2_plain(tf, tb, 7, variant, 8),
                           rs.roi_stage2_plain(tf, tb, 7, variant, 16))


def test_make_inputs_match_jax(jax_exp):
    feats, boxes = jax_exp.make_inputs(b=2, k=5, c=8, canvas=64, seed=3)
    tf, tb = port_exp.make_inputs(2, 5, 8, 64, seed=3, device='cpu')
    for a, t in zip(feats, tf):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), t.float().numpy())
    np.testing.assert_array_equal(np.asarray(boxes), tb.numpy())


@pytest.mark.parametrize('canvas,k,seed', [(256, 37, 0), (160, 16, 1)])
def test_separable_inputs_bf16_bit_exact_vs_jax(canvas, k, seed):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 1, (2, canvas // 2 ** l, canvas // 2 ** l, 16)).astype('float32')
             for l in range(2, 6)]
    centers = rng.uniform(0, canvas, (2, k, 2))
    sizes = rng.uniform(2, 1.2 * canvas, (2, k, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype('float32')
    jf, jwy, jwx = jax_separable_inputs(tuple(jnp.asarray(f, jnp.bfloat16) for f in feats),
                                        jnp.asarray(boxes), 7, 2)
    tf, twy, twx = _separable_inputs([torch.from_numpy(f).to(torch.bfloat16) for f in feats],
                                     torch.from_numpy(boxes), 7, 2, as_dtype=torch.bfloat16)
    assert tf.dtype == twy.dtype == twx.dtype == torch.bfloat16
    for ours, ref in ((tf.reshape(jf.shape), jf), (twy, jwy), (twx, jwx)):
        np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))


BOX = (16, 16, 256, 75, 40)           # the main path's box shape: b, k, c, sum H, Wmax
EXP = (64, 256, 256, 120, 64)         # the experiment's shape


@pytest.mark.parametrize('variant,shape,bk,cs,grid,kp,hp,wp,smem,pairs', [
    # one block per (cs channels, image), its warps walking the image's ROIs
    # two at a time at either block_k, the same plan for every variant
    ('dotswap', BOX, 8, 16, (16, 1, 16), 16, 80, 48, 195200, 8),
    ('transpose', BOX, 8, 16, (16, 1, 16), 16, 80, 48, 195200, 8),
    ('retile', BOX, 8, 16, (16, 1, 16), 16, 80, 48, 195200, 8),
    ('retile', BOX, 16, 16, (16, 1, 16), 16, 80, 48, 195200, 8),
    ('noxpose', BOX, 8, 16, (16, 1, 16), 16, 80, 48, 195200, 8),
    ('noxpose', BOX, 16, 16, (16, 1, 16), 16, 80, 48, 195200, 8),
    ('transpose', EXP, 16, 8, (32, 1, 64), 256, 128, 64, 219264, 128),
    ('dotswap', EXP, 8, 8, (32, 1, 64), 256, 128, 64, 219264, 128),
    ('retile', EXP, 8, 8, (32, 1, 64), 256, 128, 64, 219264, 128),
    ('retile', EXP, 16, 8, (32, 1, 64), 256, 128, 64, 219264, 128),
    ('noxpose', EXP, 8, 8, (32, 1, 64), 256, 128, 64, 219264, 128),
    ('noxpose', EXP, 16, 8, (32, 1, 64), 256, 128, 64, 219264, 128),
    # K not a multiple of block_k
    ('noxpose', (2, 13, 32, 75, 40), 8, 16, (2, 1, 2), 16, 80, 48, 195200, 8),
    ('retile', (1, 21, 16, 45, 24), 16, 16, (1, 1, 1), 32, 48, 32, 108160, 16),
])
def test_launch_plan(variant, shape, bk, cs, grid, kp, hp, wp, smem, pairs):
    b, k, c, h, w = shape
    plan = rs.launch_plan(variant, b, k, c, h, w, bk)
    assert (plan.cs, plan.grid, plan.kp, plan.hp, plan.wp, plan.smem_bytes, plan.pairs) == \
        (cs, grid, kp, hp, wp, smem, pairs)
    assert plan.blocks == grid[0] * grid[1] * grid[2]
    assert plan.grid[0] * plan.cs == c
    assert plan.hp % rs.MMA_DEPTH == 0 and plan.wp % rs.MMA_DEPTH == 0
    assert 0 <= plan.hp - h < 16 and 0 <= plan.wp - w < 16 and 0 <= plan.kp - k < bk
    assert plan.smem_bytes <= rs.MAX_SMEM_BYTES
    assert plan.smem_bytes == rs.resident_smem_bytes(plan.cs, hp, wp)
    assert plan.cs == 8 or rs.resident_smem_bytes(16, hp, wp) <= rs.MAX_SMEM_BYTES
    assert plan.cs == 16 or rs.resident_smem_bytes(16, hp, wp) > rs.MAX_SMEM_BYTES


def test_resident_smem_at_the_experiments_shape():
    '''At cs 8: the warps' mbarriers (128 B), the F slice 128 x (64 x 8 + 8)
    x 2 B, each of 8 warps' 16 Wy rows of 136 and 16 Wx rows of 72 elements
    and its T tile of 4 KB.'''
    assert rs.resident_smem_bytes(8, 128, 64) == \
        128 + 128 * 520 * 2 + 2 * 64 * 136 * 2 + 2 * 64 * 72 * 2 + 32768 == 219264
    assert rs.resident_smem_bytes(16, 128, 64) > rs.MAX_SMEM_BYTES
    assert rs.resident_cs(128, 64) == 8 and rs.resident_cs(80, 48) == 16


@pytest.mark.parametrize('args,match', [
    (('blockdiag', 1, 8, 256, 75, 40, 8), 'variant'),
    (('dotswap', 1, 8, 256, 75, 40, 4), 'block_k'),
    (('dotswap', 1, 8, 24, 75, 40, 8), 'channels'),
    # from the shared-memory budget of the F slice, whatever block_k is
    (('transpose', 1, 8, 256, 480, 256, 16), 'shared memory'),
    # the 8-channel slice of a pyramid of 256 stacked rows does not fit
    (('noxpose', 1, 8, 256, 256, 64, 8), '8-channel slice'),
    (('retile', 1, 8, 256, 240, 64, 16), '8-channel slice'),
])
def test_launch_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        rs.launch_plan(*args)


@pytest.mark.parametrize('block_k', [8, 16])
def test_stage2_inputs_padding(block_k):
    '''The kernels' inputs: the separable inputs in bf16, zero past sum H,
    Wmax and the K real ROIs.'''
    tf, tb = port_exp.make_inputs(2, 13, 16, 160, seed=6, device='cpu')
    f, wy, wx = rs.stage2_inputs(tf, tb, 7, block_k)
    ref_f, ref_wy, ref_wx = _separable_inputs(tf, tb, 7, 2, as_dtype=torch.bfloat16)
    assert f.shape == (2, 80, 48, 16) and wy.shape == (2, 16, 7, 80) and wx.shape == (2, 16, 7, 48)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in (f, wy, wx))
    assert torch.equal(f[:, :75, :40], ref_f)
    assert torch.equal(wy[:, :13, :, :75], ref_wy) and torch.equal(wx[:, :13, :, :40], ref_wx)
    assert not f[:, 75:].any() and not f[:, :, 40:].any()
    assert not wy[:, 13:].any() and not wy[..., 75:].any()
    assert not wx[:, 13:].any() and not wx[..., 40:].any()


@pytest.mark.parametrize('block_k', [8, 16])
def test_tile_counts_and_mma_count(block_k):
    '''The tiles a kernel's block walks, against a loop over its blocks; the
    mma counts from them.'''
    tf, tb = port_exp.make_inputs(2, 21, 32, 160, seed=10, device='cpu')
    _, wy, wx = rs.stage2_inputs(tf, tb, 7, block_k)
    wy[1, 3:] = 0                        # the second image's ROIs past 3 weigh nothing:
    wx[1, 3:] = 0                        # its ROI blocks of zero weights walk nothing
    n_ht, n_wt = rs.tile_counts(wy, wx, block_k)
    for b in range(2):
        for kb in range(wy.shape[1] // block_k):
            rows = slice(kb * block_k, (kb + 1) * block_k)
            h = torch.nonzero(wy[b, rows].reshape(-1, wy.shape[-1]).any(0)).flatten()
            w = torch.nonzero(wx[b, rows].reshape(-1, wx.shape[-1]).any(0)).flatten()
            if len(h) and len(w):
                expect = (int(h.max()) // 16 - int(h.min()) // 16 + 1,
                          int(w.max()) // 16 - int(w.min()) // 16 + 1)
            else:
                expect = (0, 0)
            assert (int(n_ht[b, kb]), int(n_wt[b, kb])) == expect
    steps = int((n_ht * n_wt).sum())
    assert steps > 0 and int(n_ht[1, -1]) == 0
    # a warp walks the tiles of 2 ROIs at a time whatever block_k is; per ROI
    # pair and 8 channels, 16 stage-1 mma per (w tile, h tile); per w tile 8
    # stage-2 mma for dotswap and noxpose, 14 for the block-diagonal product
    # of retile and transpose
    p_ht, p_wt = rs.tile_counts(wy, wx, 2)
    p_steps, p_w_tiles = int((p_ht * p_wt).sum()), int(p_wt.sum())
    for variant in ('dotswap', 'noxpose'):
        assert rs.mma_count(variant, wy, wx, block_k, 32) == \
            (4 * p_steps * 16, 4 * p_w_tiles * 8)
    for variant in ('retile', 'transpose'):
        assert rs.mma_count(variant, wy, wx, block_k, 32) == \
            (4 * p_steps * 16, 4 * p_w_tiles * 14)
    # a pair's tiles lie inside its group's: no more steps than block_k / 2
    # pairs walking the group's tiles
    assert p_steps <= block_k // 2 * steps


def test_mma_count_pairs_the_twins():
    '''transpose issues retile's mma and dotswap noxpose's, on the same
    weights, at both block_k; all four share stage 1.'''
    tf, tb = port_exp.make_inputs(2, 19, 48, 256, seed=12, device='cpu')
    _, wy, wx = rs.stage2_inputs(tf, tb, 7, 8)
    wy[0, 5:9] = 0
    wx[0, 5:9] = 0
    counts = {(v, k): rs.mma_count(v, wy, wx, k, 48) for v in rs.VARIANTS for k in (8, 16)}
    for k in (8, 16):
        assert counts[('transpose', k)] == counts[('retile', k)] == counts[('retile', 8)]
        assert counts[('dotswap', k)] == counts[('noxpose', k)] == counts[('noxpose', 8)]
        assert len({counts[(v, k)][0] for v in rs.VARIANTS}) == 1
        assert counts[('retile', k)][1] * 8 == counts[('noxpose', k)][1] * 14 > 0


def kernel_walk(variant, wy, wx, block_k, channels):
    '''A mirror of a kernel's loops: for each block (channel slice, image),
    the pairs of ROIs its 8 warps walk, each pair's nonzero h and w tile
    ranges, then per 8 channels the w tiles and, inside, the h tiles.
    Returns the visits, a Counter of (image, ROI, h tile, w tile, channel),
    and the (stage 1, stage 2) mma the loops issue.'''
    b, kp, _, hp = wy.shape
    wp = wx.shape[-1]
    plan = rs.launch_plan(variant, b, kp, channels, hp, wp, block_k)
    rois, unit = rs.PAIR, rs.UNIT_CHANNELS
    visits, stage1, stage2 = Counter(), 0, 0
    for cslice in range(plan.grid[0]):
        for img in range(b):
            for pair in range(plan.pairs):
                sel = slice(pair * rois, (pair + 1) * rois)
                h = torch.nonzero(wy[img, sel].reshape(-1, hp).any(0)).flatten()
                w = torch.nonzero(wx[img, sel].reshape(-1, wp).any(0)).flatten()
                if not len(h) or not len(w):
                    continue
                for u in range(plan.cs // unit):
                    c0 = cslice * plan.cs + u * unit
                    for wt in range(int(w.min()) // 16, int(w.max()) // 16 + 1):
                        for ht in range(int(h.min()) // 16, int(h.max()) // 16 + 1):
                            visits.update((img, roi, ht, wt, c)
                                          for roi in range(pair * rois, (pair + 1) * rois)
                                          for c in range(c0, c0 + unit))
                            stage1 += 16
                        if variant in ('dotswap', 'noxpose'):
                            stage2 += 2 * 4                 # 2 ROIs x 4 oy pairs
                        else:
                            stage2 += 7 * 2                 # 7 oy x 2 k tiles
    return visits, (stage1, stage2)


@pytest.mark.parametrize('variant', rs.VARIANTS)
@pytest.mark.parametrize('block_k', [8, 16])
def test_kernel_walk_covers_each_tile_once_and_counts_the_mma(variant, block_k):
    '''The walk visits each (ROI, h tile, w tile, channel) at most once, and
    every h and w tile where a ROI's own weights are nonzero, for every
    channel; mma_count is the walk's count.'''
    tf, tb = port_exp.make_inputs(2, 21, 48, 160, seed=11, device='cpu')
    _, wy, wx = rs.stage2_inputs(tf, tb, 7, block_k)
    wy[1, 2:16] = 0                      # a partly zero group, an all-zero one at block_k 8
    wx[1, 2:16] = 0
    visits, counts = kernel_walk(variant, wy, wx, block_k, 48)
    assert max(visits.values()) == 1
    for img in range(2):
        for roi in range(21):
            h = torch.nonzero(wy[img, roi].any(0)).flatten()
            w = torch.nonzero(wx[img, roi].any(0)).flatten()
            if not len(h) or not len(w):
                assert img == 1 and 2 <= roi < 16
                continue
            for ht in {int(x) // 16 for x in h}:
                for wt in {int(x) // 16 for x in w}:
                    assert all((img, roi, ht, wt, c) in visits for c in range(48))
    assert counts == rs.mma_count(variant, wy, wx, block_k, 48)


def test_cpu_dispatch_runs_the_plain_version_without_launching():
    tf, tb = port_exp.make_inputs(1, 9, 16, 128, seed=7, device='cpu')
    before = dict(rs.launch_count)
    for variant in rs.VARIANTS:
        out = rs.roi_stage2(tf, tb, 7, variant, 8)
        assert torch.equal(out, rs.roi_stage2_plain(tf, tb, 7, variant, 8))
    assert rs.launch_count == before == dict.fromkeys(rs.VARIANTS, 0)


def test_cuda_wrapper_refuses_cpu_tensors():
    tf, tb = port_exp.make_inputs(1, 8, 16, 128, seed=8, device='cpu')
    inputs = rs.stage2_inputs(tf, tb, 7, 8)
    for variant in rs.VARIANTS:
        with pytest.raises(ValueError, match='CUDA'):
            rs.roi_stage2_cuda(*inputs, 8, variant, 8)


def test_dispatch_refuses_what_the_kernels_do_not_take():
    tf, tb = port_exp.make_inputs(1, 8, 16, 128, seed=9, device='cpu')
    with pytest.raises(ValueError, match='output_size'):
        rs.roi_stage2(tf, tb, 14, 'dotswap')
    with pytest.raises(ValueError, match='out_dtype'):
        rs.roi_stage2(tf, tb, 7, 'dotswap', out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='block_k'):
        rs.roi_stage2(tf, tb, 7, 'noxpose', block_k=32)


def test_port_experiment_main_on_the_cpu(capsys):
    result = port_exp.main(device='cpu', check_shape=(1, 8, 16, 64))
    assert set(result['errors']) == {label for label, _, _ in port_exp.RUNS}
    assert all(err < 0.05 for err in result['errors'].values())
    assert 'timing requires the card' in capsys.readouterr().out


def test_port_experiment_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the CUDA run would time at full size')
    with pytest.raises(RuntimeError, match='cuda'):
        port_exp.cli([])
