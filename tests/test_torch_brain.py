'''The port's host brain (``proc/features.py:finish_instance_features``, the
flip votes and keypoint helpers, ``proc/angles.py`` and the angle filter of
``proc/kalman.py``) against the JAX package's, on the CPU, fed identical
inputs: the JAX dispatch's own moments and keypoints.

Tolerances: the angle filter is a jitted f64 scan in the reference and a
plain f64 loop here, held as ``tests/test_proc.py`` holds the scan against
the loop: angles to 1e-8, flips equal, the tracker's last mean and
covariance to 1e-9. The Kalman smoothing runs ``steady`` (bit for bit)
where no row is missing, and meets the reference's scan to 1e-8 where rows
are. ``iterative_filter_angles`` is f32 on both sides, bit for bit. The
feature smoothing (``hampel_filter``, ``feature_hampel_filter``,
``interpolate_nan_values``) is f64 numpy on both sides, bit for bit.
'''
import warnings

import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu.proc import angles as jangles
from moseq2_detectron_extract_tpu.proc import features as jfeatures
from moseq2_detectron_extract_tpu.proc import kalman as jk
from moseq2_detectron_extract_tpu_torch.proc import angles as pangles
from moseq2_detectron_extract_tpu_torch.proc import features as pfeatures
from moseq2_detectron_extract_tpu_torch.proc import kalman as pk

KEYS = ('centroid', 'orientation', 'axis_length')


def recipe_chunk(n=60, seed=3):
    '''``tests/test_proc.py:285-309``'s chunk: an ellipse walking and turning,
    with keypoints flipped every 11th frame (a big deviation) and scrambled
    every 7th (a low alignment score).'''
    import cv2
    rng = np.random.default_rng(seed)
    h, w = 128, 160
    raw = np.zeros((n, h, w), dtype='uint8')
    masks = np.zeros((n, h, w), dtype='uint8')
    kpts = np.zeros((n, 8, 3))
    for i in range(n):
        cx, cy = 60 + i % 30, 55
        ang = (i * 7) % 360
        cv2.ellipse(raw[i], (cx, cy), (34, 17), ang, 0, 360, 40, -1)
        cv2.ellipse(masks[i], (cx, cy), (36, 19), ang, 0, 360, 1, -1)
        base = np.array([[30, 0], [24, 7], [24, -7], [18, 0],
                         [-12, 7], [-12, -7], [-20, 0], [-32, 0]], dtype=float)
        if i % 11 == 0:
            base = -base
        if i % 7 == 0:
            rng.shuffle(base)
        rad = np.deg2rad(ang)
        rot = np.array([[np.cos(rad), -np.sin(rad)], [np.sin(rad), np.cos(rad)]])
        kpts[i, :, :2] = base @ rot.T + [cx, cy]
        kpts[i, :, 2] = 0.95
    return raw, masks, kpts


def jax_dispatch(masks, raw):
    '''The JAX dispatch, and the same moments handed to the port as tensors.'''
    ref = jfeatures.dispatch_instance_features(masks, raw)
    ours = {'cleaned_frames': torch.from_numpy(np.array(ref['cleaned_frames'])),
            'feat_masks': torch.from_numpy(np.array(ref['feat_masks'])),
            'feats_dev': {k: torch.from_numpy(np.array(ref['feats_dev'][k])) for k in KEYS},
            'window_origins': None}
    return ours, ref


def trackers(mod, tracking=True, n_kpts=8):
    if not tracking:
        return None, None
    point = mod.KalmanTracker([mod.KalmanTrackerPoint2D(order=3),
                               mod.KalmanTrackerNPoints2D(n_kpts, order=3)])
    angle = mod.KalmanTracker([mod.KalmanTrackerAngle(order=3, degrees=True)])
    return point, angle


@pytest.fixture(scope='module')
def chunk():
    raw, masks, kpts = recipe_chunk()
    return raw, masks, kpts, jax_dispatch(masks, raw)


@pytest.fixture(scope='module')
def nan_chunk():
    raw, masks, kpts = recipe_chunk(n=40, seed=5)
    kpts[10:13] = np.nan
    masks[10:13] = 0
    kpts[30, 2] = np.nan                              # one keypoint lost
    return raw, masks, kpts, jax_dispatch(masks, raw)


def _compare_brain(ours, ref, exact):
    close = dict(rtol=0, atol=0) if exact else dict(rtol=0, atol=1e-8)
    for key in KEYS:
        assert ours['features'][key].dtype == np.asarray(ref['features'][key]).dtype, key
        np.testing.assert_allclose(ours['features'][key], ref['features'][key], err_msg=key,
                                   **close)
    np.testing.assert_array_equal(ours['flips'], ref['flips'])
    np.testing.assert_allclose(ours['keypoints'], ref['keypoints'], **close)
    np.testing.assert_array_equal(ours['num_instances'], ref['num_instances'])


def _run_both(data, spans, tracking=True, debug=False, tmp_path=None):
    raw, masks, kpts, _ = data
    ours_t, ref_t = trackers(pk, tracking), trackers(jk, tracking)
    outs = []
    for lo, hi in spans:
        d_ours, d_ref = jax_dispatch(masks[lo:hi], raw[lo:hi])
        kw = dict(debug=debug, debug_dir=str(tmp_path)) if debug else {}
        ones = np.ones(hi - lo)
        outs.append((pfeatures.finish_instance_features(d_ours, kpts[lo:hi].copy(), ones,
                                                        *ours_t, **kw),
                     jfeatures.finish_instance_features(d_ref, kpts[lo:hi].copy(), ones,
                                                        *ref_t, **kw)))
    return outs, ours_t, ref_t


@pytest.mark.parametrize('tracking', [True, False], ids=['tracking', 'no-tracking'])
def test_finish_instance_features_across_a_chunk_boundary(chunk, tracking):
    outs, ours_t, ref_t = _run_both(chunk, [(0, 30), (30, 60)], tracking)
    for ours, ref in outs:
        _compare_brain(ours, ref, exact=not tracking)
        assert ours['cleaned_frames'].shape == tuple(np.asarray(ref['cleaned_frames']).shape)
    if tracking:
        for a, b in zip(ours_t, ref_t):
            np.testing.assert_allclose(a.last_mean, b.last_mean, rtol=0, atol=1e-9)
            np.testing.assert_allclose(a.last_covar, b.last_covar, rtol=0, atol=1e-9)


@pytest.mark.parametrize('tracking', [True, False], ids=['tracking', 'no-tracking'])
def test_finish_instance_features_with_nan_frames(nan_chunk, tracking):
    outs, ours_t, _ = _run_both(nan_chunk, [(0, 20), (20, 40)], tracking)
    for ours, ref in outs:
        _compare_brain(ours, ref, exact=False)
    if tracking:
        assert all(np.isfinite(t.last_mean).all() for t in ours_t)


def test_debug_loop_writes_flip_info_and_meets_the_filter(chunk, tmp_path):
    '''The per-frame debug loop against the reference's debug loop, and
    against the port's default path (the filter loop), as
    ``tests/test_proc.py`` holds the reference's scan against its loop.'''
    (pair,), ours_t, ref_t = _run_both(chunk, [(0, 60)], debug=True, tmp_path=tmp_path)
    _compare_brain(*pair, exact=False)
    ((default, _),), plain_t, _ = _run_both(chunk, [(0, 60)])
    np.testing.assert_allclose(default['features']['orientation'],
                               pair[0]['features']['orientation'], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(default['flips'], pair[0]['flips'])
    np.testing.assert_allclose(plain_t[1].last_mean, ours_t[1].last_mean, atol=1e-9)
    np.testing.assert_allclose(plain_t[1].last_covar, ours_t[1].last_covar, atol=1e-9)
    assert len(list(tmp_path.glob('flip_info*.tsv'))) == 2
    ours_rows, ref_rows = ((tmp_path / name).read_text().splitlines()    # the port's first
                           for name in ('flip_info.tsv', 'flip_info.1.tsv'))
    assert ours_rows[0] == ref_rows[0] and len(ours_rows) == len(ref_rows) == 61
    assert any('flip 180' in l for l in ours_rows)
    assert any('defer to sample' in l for l in ours_rows)


def _angle_inputs(seed, n):
    rng = np.random.default_rng(seed)
    angles = (np.arange(n) * 7.0 + rng.normal(0, 3, n)) % 360
    angles[rng.random(n) < 0.1] += 180                 # flips -> deviations over 140
    angles %= 360
    scores = rng.uniform(0.2, 1.0, n)                 # some below 0.4 -> defer
    angles[[5, 17]] = np.nan
    scores[[5, 9, 23]] = np.nan
    return angles, scores


def test_angle_intervention_filter_meets_the_scan():
    '''Both filters from one EM-initialised angle tracker, over two chunks
    carrying the state, with NaN angles and scores.'''
    angles, scores = _angle_inputs(2, 80)
    tracker = jk.KalmanTracker([jk.KalmanTrackerAngle(order=3, degrees=True)])
    tracker.initialize([angles[:40]])
    state = {'ours': (tracker.last_mean, tracker.last_covar),
             'ref': (tracker.last_mean, tracker.last_covar)}
    fired = set()
    for lo, hi in ((0, 40), (40, 80)):
        o_ang, o_flip, o_mean, o_cov = pk.angle_intervention_filter(
            tracker.params, *state['ours'], angles[lo:hi], scores[lo:hi])
        r_ang, r_flip, r_mean, r_cov = jk.angle_intervention_filter(
            tracker.params, *state['ref'], angles[lo:hi], scores[lo:hi])
        np.testing.assert_allclose(o_ang, r_ang, rtol=0, atol=1e-8)
        np.testing.assert_array_equal(o_flip, r_flip)
        np.testing.assert_allclose(o_mean, r_mean, rtol=0, atol=1e-9)
        np.testing.assert_allclose(o_cov, r_cov, rtol=0, atol=1e-9)
        state = {'ours': (o_mean, o_cov), 'ref': (r_mean, r_cov)}
        fired |= {'flip'} if o_flip.any() else set()
        fired |= {'defer'} if (scores[lo:hi] < 0.4).any() else set()
    assert fired == {'flip', 'defer'}
    assert np.isfinite(state['ours'][0]).all()


@pytest.mark.parametrize('n', [1, 2, 3, 50, 200])
def test_iterative_filter_angles_bit_for_bit(n):
    rng = np.random.default_rng(n)
    angles = np.cumsum(rng.normal(0, 5, n)) % 360
    flipped = rng.random(n) < 0.2
    angles[flipped] = (angles[flipped] + 180) % 360
    if n > 10:
        angles[7] = np.nan                             # never converges: max_iters
    ours, ours_flips = pangles.iterative_filter_angles(angles, max_iters=40)
    ref, ref_flips = jangles.iterative_filter_angles(angles, max_iters=40)
    assert ours.dtype == np.asarray(ref).dtype == np.float32
    np.testing.assert_array_equal(ours, np.asarray(ref))
    np.testing.assert_array_equal(ours_flips, np.asarray(ref_flips))
    for window in (3, 5):
        np.testing.assert_array_equal(pangles.filter_angles(angles, window=window),
                                      np.asarray(jangles.filter_angles(angles, window=window)))


def test_angle_helpers_are_jaxs():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(-720, 720, 50), rng.uniform(-720, 720, 50)
    np.testing.assert_array_equal(pangles.angle_difference(a, b), jfeatures.angle_difference(a, b))
    np.testing.assert_array_equal(pangles.clamp_angles_deg(a), jfeatures.clamp_angles_deg(a))


def test_keypoint_helpers_are_jaxs(chunk):
    _, _, kpts, (ours_d, _) = chunk
    centroids = ours_d['feats_dev']['centroid'].numpy().astype(float)
    lengths = ours_d['feats_dev']['axis_length'].numpy().astype(float).max(axis=1)
    angles = np.random.default_rng(1).uniform(0, 360, len(kpts))
    for a, b in zip(pfeatures.flips_from_keypoints(kpts, centroids, angles, lengths),
                    jfeatures.flips_from_keypoints(kpts, centroids, angles, lengths)):
        np.testing.assert_array_equal(a, b)
    for metric in ('x', 'y', 'euclidean'):
        np.testing.assert_array_equal(pfeatures.calc_keypoint_keypoint_distance(kpts, metric),
                                      jfeatures.calc_keypoint_keypoint_distance(kpts, metric))
    np.testing.assert_array_equal(pfeatures.get_expected_keypoint_alignment(),
                                  jfeatures.get_expected_keypoint_alignment())
    np.testing.assert_array_equal(pfeatures.compute_keypoint_alignment_scores(kpts[:, :7, :2]),
                                  jfeatures.compute_keypoint_alignment_scores(kpts[:, :7, :2]))
    np.testing.assert_array_equal(pfeatures.estimate_keypoint_rotation(kpts[:, :7, :2]),
                                  jfeatures.estimate_keypoint_rotation(kpts[:, :7, :2]))


def _noisy_track(seed, n=120, cols=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if cols is None else (n, cols)
    data = np.cumsum(rng.normal(0, 1, shape), axis=0)
    spikes = rng.choice(n, 9, replace=False)
    data[spikes] += rng.choice([-40.0, 40.0], (9,) + shape[1:])
    data[40:52] = np.nan                                     # a gap longer than the span
    data[0] = np.nan
    return data


@pytest.mark.parametrize('span', [5, 8, 11])
@pytest.mark.parametrize('cols', [None, 3], ids=['1d', '2d'])
def test_hampel_filter_bit_for_bit(span, cols):
    data = _noisy_track(span, cols=cols)
    with warnings.catch_warnings():
        warnings.simplefilter('error')                       # all-NaN windows stay silent
        ours = pangles.hampel_filter(data, span, sigma=2)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        ref = jangles.hampel_filter(data, span, sigma=2)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == np.float64 and not np.array_equal(ours, data, equal_nan=True)
    with pytest.raises(ValueError, match='3 dimentions'):
        pangles.hampel_filter(np.zeros((4, 3, 2)), span)


def test_feature_hampel_filter_in_place_bit_for_bit():
    def feats():
        return {'centroid': _noisy_track(1, cols=2), 'orientation': _noisy_track(2),
                'axis_length': _noisy_track(3, cols=2)}
    ours, ref = feats(), feats()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        jangles.feature_hampel_filter(ref, centroid_hampel_span=7, angle_hampel_span=9,
                                      angle_hampel_sig=2)
    out = pangles.feature_hampel_filter(ours, centroid_hampel_span=7, angle_hampel_span=9,
                                        angle_hampel_sig=2)
    assert out is ours
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    untouched = feats()
    assert pangles.feature_hampel_filter(untouched, 0, 3, None) is untouched
    for key, value in feats().items():
        np.testing.assert_array_equal(untouched[key], value, err_msg=key)


@pytest.mark.parametrize('case', ['gaps', 'none', 'all'])
def test_interpolate_nan_values_bit_for_bit(case):
    data = _noisy_track(4)
    data[-5:] = np.nan
    if case == 'none':
        data = np.nan_to_num(data)
    elif case == 'all':
        data[:] = np.nan
    ours = pangles.interpolate_nan_values(data)
    np.testing.assert_array_equal(ours, jangles.interpolate_nan_values(data))
    assert ours is not data and np.isnan(ours).all() == (case == 'all')
