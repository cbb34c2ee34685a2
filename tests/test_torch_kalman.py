'''The port's Kalman module (``proc/kalman.py`` and its C++ core) against the
JAX package's, on the CPU.

Tolerances: the tracker items, the ``steady`` and ``numpy`` smoothers and
EM are the reference's numpy operations in the same order, so they are held
bit for bit. The port's smoother for chunks with missing rows meets the
reference's ``scan`` backend (a jitted f64 ``lax.scan``, another order of
the same sums) to 1e-8, the tolerance ``tests/test_proc.py`` holds the scan
to; the C++ core (Cholesky solves) meets numpy to 1e-9, as there. The
port's ``scan`` backend (the numpy recurrence) meets the
reference's to 1e-9 of each array's largest magnitude (about 4e-15
measured), as do the automatic backend choice and the tracker's ``smooth``
and ``filter`` (the reference's filter runs its C++ core, the port's
numpy). The gap helpers are numpy on both sides, bit for bit.
'''
import logging

import numpy as np
import pytest

from moseq2_detectron_extract_tpu.proc import kalman as jk
from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.proc import kalman as pk

S, O, T = 12, 4, 200


def _params(mod, rng=None):
    A = np.eye(S) + np.diag(np.ones(S - 1) * 0.1, 1)
    C = np.zeros((O, S))
    C[np.arange(O), np.arange(O) * 3] = 1
    Q = np.eye(S) * 0.01
    if rng is not None:
        m = rng.normal(0, 0.05, (S, S))
        Q = Q + m @ m.T
    return mod.KalmanParams(A, C, Q, np.eye(O), np.zeros(S), np.eye(S))


def _obs(seed, missing_rows=()):
    rng = np.random.default_rng(seed)
    obs = np.cumsum(rng.normal(0, 1, (T, O)), axis=0)
    missing = np.zeros(T, bool)
    for lo, hi in missing_rows:
        missing[lo:hi] = True
    return obs, missing


def _assert_smooth(ours, ref, **tol):
    check = np.testing.assert_array_equal if not tol else \
        lambda a, b, err_msg: np.testing.assert_allclose(a, b, err_msg=err_msg, **tol)
    for key in ('means', 'covs', 'lag_one_covs'):
        check(ours[key], np.asarray(ref[key]), err_msg=key)
    for key in ('means', 'covs', 'pred_means', 'pred_covs'):
        check(ours['filtered'][key], np.asarray(ref['filtered'][key]), err_msg=f'filtered/{key}')


ITEMS = {
    'point1d': lambda m: m.KalmanTrackerPoint1D(order=3),
    'point2d': lambda m: m.KalmanTrackerPoint2D(order=3),
    'point2d-order2': lambda m: m.KalmanTrackerPoint2D(order=2, delta_t=0.5),
    'angle': lambda m: m.KalmanTrackerAngle(order=3, degrees=True),
    'angle-radians': lambda m: m.KalmanTrackerAngle(order=3, degrees=False),
    'npoints': lambda m: m.KalmanTrackerNPoints2D(8, order=3),
}


def _item_data(name, rng):
    n = 7
    if name == 'point1d':
        return rng.normal(0, 50, n)
    if name.startswith('angle'):
        return rng.uniform(0, 360, n)
    if name == 'npoints':
        return rng.normal(100, 30, (n, 8, 2))
    return rng.normal(100, 30, (n, 2))


@pytest.mark.parametrize('name', sorted(ITEMS))
def test_tracker_items_are_jaxs(name):
    ours, ref = ITEMS[name](pk), ITEMS[name](jk)
    rng = np.random.default_rng(4)
    data = _item_data(name, rng)
    assert ours.state_size == ref.state_size
    np.testing.assert_array_equal(ours.build_trans_mat(), ref.build_trans_mat())
    np.testing.assert_array_equal(ours.build_observ_mat(), ref.build_observ_mat())
    assert ours.build_trans_mat().dtype == ref.build_trans_mat().dtype
    np.testing.assert_array_equal(ours.build_init_state_means(data),
                                  ref.build_init_state_means(data))
    formatted = ours.format_data(data)
    np.testing.assert_array_equal(formatted, ref.format_data(data))
    state = rng.normal(0, 1, (5, ours.state_size))
    np.testing.assert_array_equal(ours.inverse_format_data(state), ref.inverse_format_data(state))


def test_block_diag_is_scipys():
    import scipy.linalg
    blocks = [np.arange(3.0), np.ones((2, 2)), np.eye(3, dtype=np.float32) * 2]
    ours = pk.block_diag(*blocks)
    ref = scipy.linalg.block_diag(*blocks)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype


@pytest.mark.parametrize('seed', [0, 1])
def test_steady_bit_for_bit(seed):
    obs, missing = _obs(seed)
    rng = np.random.default_rng(seed + 10)
    _assert_smooth(pk.kalman_smooth(_params(pk, rng), obs, missing),
                   jk.kalman_smooth(_params(jk, np.random.default_rng(seed + 10)), obs, missing))


@pytest.mark.parametrize('missing_rows', [(), ((50, 60),), ((0, 3), (120, 121), (197, 200))],
                         ids=['none', 'block', 'edges'])
def test_numpy_bit_for_bit(missing_rows):
    obs, missing = _obs(2, missing_rows)
    _assert_smooth(pk.kalman_smooth(_params(pk), obs, missing, backend='numpy'),
                   jk.kalman_smooth(_params(jk), obs, missing, backend='numpy'))
    ours = pk.kalman_filter(_params(pk), obs, missing)
    ref = jk.kalman_filter(_params(jk), obs, missing, use_native=False)
    for key in ours:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize('seed', [0, 3])
def test_em_bit_for_bit(seed):
    obs, missing = _obs(seed)
    ours = pk.kalman_em(_params(pk), obs, missing, n_iter=4)
    ref = jk.kalman_em(_params(jk), obs, missing, n_iter=4)
    for a, b, name in zip(ours, ref, ours._fields):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize('missing_rows', [((50, 60),), ((0, 3), (120, 121), (197, 200))],
                         ids=['block', 'edges'])
def test_missing_rows_backend_meets_scan(missing_rows):
    '''The reference picks its jitted f64 scan where rows are missing; the
    port picks ``MISSING_ROWS_BACKEND``.'''
    if not jk._scan_available():
        pytest.skip('f64 LAPACK not registered on this jax CPU backend')
    obs, missing = _obs(5, missing_rows)
    _assert_smooth(pk.kalman_smooth(_params(pk), obs, missing),
                   jk.kalman_smooth(_params(jk), obs, missing, backend='scan'),
                   rtol=0, atol=1e-8)


@pytest.mark.parametrize('missing_rows', [(), ((50, 60),)], ids=['none', 'block'])
def test_native_meets_numpy(missing_rows):
    obs, missing = _obs(6, missing_rows)
    params = _params(pk)
    _assert_smooth(pk.kalman_smooth(params, obs, missing, backend='native'),
                   pk.kalman_smooth(params, obs, missing, backend='numpy'),
                   rtol=0, atol=1e-9)
    ours = pk.kalman_filter(params, obs, missing, use_native=True)
    ref = jk.kalman_filter(_params(jk), obs, missing, use_native=False)
    for key in ours:
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=1e-9, err_msg=key)


def test_native_core_built_from_csrc():
    path = native.build_host_library(native.KALMAN_SOURCE, native.KALMAN_LIB_NAME)
    assert path.startswith(native.BUILD_DIR) and path.endswith(native.KALMAN_LIB_NAME)
    assert native.load_kalman_library() is native.load_kalman_library()


def test_native_failure_falls_to_numpy_counted(caplog, monkeypatch):
    '''An observation covariance that no jitter makes positive definite makes
    the C++ core's filter return rc 1, and its smoother too on the covariances
    that follow: each call runs in numpy instead, counted, logged once.'''
    monkeypatch.setattr(pk, 'native_fallbacks', 0)
    obs, missing = _obs(7)
    params = _params(pk)._replace(observation_cov=-4.0 * np.eye(O))
    with caplog.at_level(logging.WARNING):
        ours = pk.kalman_smooth(params, obs, missing, backend='native')
        again = pk.kalman_smooth(params, obs, missing, backend='native')
    assert pk.native_fallbacks == 4                # filter and smoother, twice
    assert sum('C++ Kalman core failed' in r.getMessage() for r in caplog.records) == 1
    ref = pk.kalman_smooth(params, obs, missing, backend='numpy')
    for out in (ours, again):
        np.testing.assert_array_equal(out['means'], ref['means'])


def test_backend_choice():
    obs, missing = _obs(8, ((10, 12),))
    with pytest.raises(ValueError, match='steady'):
        pk.kalman_smooth(_params(pk), obs, missing, backend='steady')
    with pytest.raises(ValueError, match='unknown backend'):
        pk.kalman_smooth(_params(pk), obs, missing, backend='lax')
    assert pk.MISSING_ROWS_BACKEND in ('numpy', 'native')
    assert 'scan' in pk.BACKENDS


def _trackers(mod):
    return mod.KalmanTracker([mod.KalmanTrackerPoint2D(order=3),
                              mod.KalmanTrackerNPoints2D(3, order=3)])


def _tracker_data(seed, n, nan_rows=()):
    rng = np.random.default_rng(seed)
    centroid = 100 + np.cumsum(rng.normal(0, 2, (n, 2)), axis=0)
    kpts = centroid[:, None, :] + rng.normal(0, 5, (n, 3, 2))
    for i in nan_rows:
        centroid[i] = np.nan
        kpts[i] = np.nan
    return [centroid, kpts]


@pytest.mark.parametrize('nan_rows', [(), (3, 40, 41, 59)], ids=['all-rows', 'missing-rows'])
def test_tracker_initialize_and_two_smooth_updates(nan_rows):
    '''EM on the finite rows, then two chunks carrying the state; without
    missing rows everything is bit for bit (steady), with them the smoothing
    meets the reference's scan to 1e-8.'''
    first = _tracker_data(9, 30, [r for r in nan_rows if r < 30])
    second = _tracker_data(10, 30, [r - 30 for r in nan_rows if r >= 30])
    ours, ref = _trackers(pk), _trackers(jk)
    ours.initialize(first)
    ref.initialize(first)
    for a, b, name in zip(ours.params, ref.params, ours.params._fields):
        np.testing.assert_array_equal(a, b, err_msg=name)
    check = (lambda a, b: np.testing.assert_array_equal(a, b)) if not nan_rows else \
        (lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-8))
    for chunk in (first, second):
        for a, b in zip(ours.smooth_update(chunk), ref.smooth_update(chunk)):
            check(a, b)
        check(ours.last_mean, ref.last_mean)
        check(ours.last_covar, ref.last_covar)
    for a, b in zip(ours.sample(2), ref.sample(2)):
        check(a, b)
    step = [d[:1] for d in _tracker_data(11, 1)]
    for a, b in zip(ours.filter_update(step), ref.filter_update(step)):
        check(a, b)
    check(ours.last_covar, ref.last_covar)


def _assert_rel(ours, ref, rel=1e-9):
    '''Every array of a smoother's result to ``rel`` of its largest magnitude.'''
    pairs = [(k, ours[k], ref[k]) for k in ('means', 'covs', 'lag_one_covs')]
    pairs += [(f'filtered/{k}', ours['filtered'][k], ref['filtered'][k])
              for k in ('means', 'covs', 'pred_means', 'pred_covs')]
    for key, a, b in pairs:
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.float64, key
        scale = np.abs(b).max() if b.size else 0.0
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=key)


def test_gap_helpers_bit_for_bit():
    rng = np.random.default_rng(12)
    steps_true = rng.choice([1, 1, 1, 2, 5], 40)
    timestamps = np.concatenate([[0.0], np.cumsum(steps_true)]) * (1000 / 30) \
        + rng.uniform(-3, 3, 41)
    steps = pk.timestamps_to_steps(timestamps)
    np.testing.assert_array_equal(steps, jk.timestamps_to_steps(timestamps))
    np.testing.assert_array_equal(steps, steps_true)
    np.testing.assert_array_equal(pk.timestamps_to_steps(timestamps, 20.0),
                                  jk.timestamps_to_steps(timestamps, 20.0))
    data = rng.normal(size=(41, 3, 2)).astype('float32')
    ours, ref = pk.expand_missing_entries(data, steps), jk.expand_missing_entries(data, steps)
    assert isinstance(ours, np.ma.MaskedArray) and ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours.data, ref.data)
    np.testing.assert_array_equal(np.ma.getmaskarray(ours), np.ma.getmaskarray(ref))
    assert int(np.ma.getmaskarray(ours)[:, 0, 0].sum()) == int(np.sum(steps_true - 1))
    back = pk.reduce_missing_entries(ours.data, steps)
    np.testing.assert_array_equal(back, jk.reduce_missing_entries(ref.data, steps))
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(pk.angle_difference([10.0, 350.0], [350.0, 10.0]),
                                  jk.angle_difference([10.0, 350.0], [350.0, 10.0]))


@pytest.mark.parametrize('missing_rows', [(), ((50, 60),), ((0, 3), (120, 121), (197, 200))],
                         ids=['none', 'block', 'edges'])
def test_scan_matches_jax_scan(missing_rows):
    if not jk._scan_available():
        pytest.skip('f64 LAPACK not registered on this jax CPU backend')
    obs, missing = _obs(13, missing_rows)
    rng = np.random.default_rng(14)
    ours = pk.kalman_smooth_scan(_params(pk, rng), obs, missing)
    _assert_rel(ours, jk.kalman_smooth_scan(_params(jk, np.random.default_rng(14)), obs,
                                            missing))
    _assert_smooth(pk.kalman_smooth(_params(pk, np.random.default_rng(14)), obs, missing,
                                    backend='scan'), ours)
    one = pk.kalman_smooth_scan(_params(pk), obs[:1], missing[:1])
    _assert_rel(one, jk.kalman_smooth_scan(_params(jk), obs[:1], missing[:1]))
    assert one['lag_one_covs'].shape == (0, S, S)


@pytest.mark.parametrize('missing_rows', [(), ((50, 60),)], ids=['none', 'block'])
def test_automatic_backend_matches_jax(missing_rows):
    '''``backend=None``: the port's choice (steady, else
    ``MISSING_ROWS_BACKEND``) against the reference's (steady, else scan).'''
    if not jk._scan_available():
        pytest.skip('f64 LAPACK not registered on this jax CPU backend')
    obs, missing = _obs(15, missing_rows)
    _assert_rel(pk.kalman_smooth(_params(pk), obs, missing),
                jk.kalman_smooth(_params(jk), obs, missing))


def test_use_native_forces_the_native_backend(monkeypatch):
    obs, missing = _obs(16)
    params = _params(pk)
    chosen = []
    monkeypatch.setattr(pk, '_filter_native',
                        lambda *a, _f=pk._filter_native: chosen.append(1) or _f(*a))
    ours = pk.kalman_smooth(params, obs, missing, use_native=True)
    assert chosen == [1]
    _assert_smooth(ours, pk.kalman_smooth(params, obs, missing, backend='native'))
    assert pk.kalman_smooth(params, obs, missing, use_native=True, backend='numpy')['means'] \
        .tobytes() == pk.kalman_smooth(params, obs, missing, backend='numpy')['means'].tobytes()


@pytest.mark.parametrize('nan_rows', [(), (3, 17, 18)], ids=['all-rows', 'missing-rows'])
def test_tracker_smooth_and_filter_keep_the_state(nan_rows):
    if not jk._scan_available():
        pytest.skip('f64 LAPACK not registered on this jax CPU backend')
    first = _tracker_data(17, 30)
    chunk = _tracker_data(18, 25, nan_rows)
    ours, ref = _trackers(pk), _trackers(jk)
    ours.initialize(first)
    ref.initialize(first)
    ours.smooth_update(first)
    ref.smooth_update(first)
    before = (ours.last_mean.copy(), ours.last_covar.copy(), [a.copy() for a in ours.params])
    for method in ('smooth', 'filter'):
        got, want = getattr(ours, method)(chunk), getattr(ref, method)(chunk)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.shape == b.shape, method
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max(),
                                       err_msg=method)
    np.testing.assert_array_equal(ours.last_mean, before[0])
    np.testing.assert_array_equal(ours.last_covar, before[1])
    for a, b in zip(ours.params, before[2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.smooth_update(chunk), ref.smooth_update(chunk)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
