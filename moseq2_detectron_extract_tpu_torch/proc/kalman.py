'''Kalman filtering, smoothing and EM of the host brain (f64, numpy and C++).

Port of ``moseq2_detectron_extract_tpu/proc/kalman.py``: the gap helpers
``timestamps_to_steps``, ``expand_missing_entries`` and
``reduce_missing_entries`` (lines 31-64), ``KalmanParams``, the filter step
(72-110), ``kalman_filter`` (123-189), ``kalman_smooth`` (211-288) with its
``numpy``, ``steady`` (291-395), ``native`` and ``scan`` (398-484)
backends, EM (589-632), the tracker items (639-767), ``KalmanTracker``
(769-908) and ``angle_intervention_filter`` (487-586).

The numpy backends and EM are the reference's numpy operations in the same
order, so they give its numbers bit for bit. The reference's ``scan``
backend is a jitted f64 ``lax.scan`` on the CPU of the same filter and
smoother; here ``scan`` and ``kalman_smooth_scan`` run the numpy recurrence,
which meets the scan to f64 round-off. Where rows are missing and no backend
is named, ``kalman_smooth`` takes ``MISSING_ROWS_BACKEND``, which is that
numpy recurrence too. The ``native`` backend is
``csrc/kalman_host.cpp``, built by g++ at its first use; when its filter or
smoother reports a numerical failure (rc != 0), that pass is done again in
numpy, as in the reference, and ``native_fallbacks`` counts it (the first is
logged).

The reference's angle filter is a jitted f64 scan; here it is a plain f64
loop over the frames with the same arithmetic (the analytic 2x2 inverse, NaN
comparisons False, a non-finite observation keeping the prediction).
'''
import ctypes
import logging
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.proc import angles

# The smoother for chunks with missing rows, chosen by a measurement on the
# H100 machine's host (chip_smoke.py phase 4b, the point tracker's S=54,
# O=18, T=1000 with 5% of the rows missing; PERF.md section 5).
MISSING_ROWS_BACKEND = 'numpy'
BACKENDS = ('steady', 'numpy', 'native', 'scan')

# Calls of the C++ core that failed (rc != 0) and ran in numpy instead;
# the first is logged.
native_fallbacks = 0


def _native_failed(what: str) -> None:
    global native_fallbacks
    native_fallbacks += 1
    if native_fallbacks == 1:
        logging.warning('the C++ Kalman core failed in %s (a covariance not positive '
                        'definite); this and any later such call run in numpy '
                        '(counted in proc.kalman.native_fallbacks)', what)


def timestamps_to_steps(timestamps, step_size=(1 / 30 * 1000)):
    '''The whole number of ``step_size`` steps (ms) between consecutive
    timestamps.'''
    return np.rint(np.diff(timestamps) / step_size).astype(int)


def expand_missing_entries(data, time_steps):
    '''Spread ``data``'s rows onto the full time grid of ``time_steps``
    (``timestamps_to_steps``): the rows in between are zero and masked.'''
    out_shape = (int(np.sum(time_steps)) + 1, *data.shape[1:])
    full = np.zeros(out_shape, dtype=data.dtype)
    mask = np.zeros(out_shape, dtype=int)
    i = j = 0
    for j, k in enumerate(time_steps):
        full[i] = data[j]
        if k > 1:
            mask[i + 1:i + k] = 1
        i += k
    full[i] = data[j + 1]
    return np.ma.masked_array(full, mask=mask)


def reduce_missing_entries(data, time_steps):
    '''The rows of full-grid ``data`` at the observed time steps (the
    inverse of :func:`expand_missing_entries`).'''
    reduced = np.zeros((time_steps.shape[0] + 1, *data.shape[1:]), dtype=data.dtype)
    i = j = 0
    for j, k in enumerate(time_steps):
        reduced[j] = data[i]
        i += k
    reduced[j + 1] = data[i]
    return reduced


def angle_difference(angles1, angles2):
    '''Smallest signed difference angles2 - angles1 in degrees, in (-180, 180].'''
    return np.asarray(angles.angle_difference(angles1, angles2))


def block_diag(*blocks) -> np.ndarray:
    '''``scipy.linalg.block_diag``: a 1-D block is one row.'''
    blocks = [np.atleast_2d(np.asarray(b)) for b in blocks]
    rows = sum(b.shape[0] for b in blocks)
    cols = sum(b.shape[1] for b in blocks)
    out = np.zeros((rows, cols), dtype=np.result_type(*blocks))
    r = c = 0
    for b in blocks:
        out[r:r + b.shape[0], c:c + b.shape[1]] = b
        r += b.shape[0]
        c += b.shape[1]
    return out


class KalmanParams(NamedTuple):
    '''Linear-Gaussian state-space parameters (float64 numpy).'''
    transition: np.ndarray        # (S, S)
    observation: np.ndarray       # (O, S)
    transition_cov: np.ndarray    # (S, S)
    observation_cov: np.ndarray   # (O, O)
    initial_mean: np.ndarray      # (S,)
    initial_cov: np.ndarray       # (S, S)


def _symmetrize(m):
    return 0.5 * (m + m.T)


def _clip_psd(m, eps: float = 1e-9):
    '''Project a symmetric matrix onto the PSD cone (eigenvalue clipping).'''
    vals, vecs = np.linalg.eigh(_symmetrize(m))
    vals = np.maximum(vals, eps)
    return _symmetrize((vecs * vals) @ vecs.T)


def kalman_filter_step(params: KalmanParams, mean, cov, obs, missing):
    '''One predict+update step. ``missing`` True skips the measurement update.

    Returns (filtered_mean, filtered_cov, predicted_mean, predicted_cov).
    '''
    A, C = params.transition, params.observation
    pred_mean = A @ mean
    pred_cov = _symmetrize(A @ cov @ A.T + params.transition_cov)

    if missing:
        return pred_mean, pred_cov, pred_mean, pred_cov

    innov = obs - C @ pred_mean
    S = C @ pred_cov @ C.T + params.observation_cov
    K = np.linalg.solve(S, C @ pred_cov).T  # P C' S^{-1}
    new_mean = pred_mean + K @ innov
    new_cov = _symmetrize(pred_cov - K @ C @ pred_cov)
    return new_mean, new_cov, pred_mean, pred_cov


def _as_c(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _filter_native(params: KalmanParams, observations, missing):
    '''The C++ forward filter, or None when it reports a failure.'''
    T = observations.shape[0]
    S = params.transition.shape[0]
    O = params.observation.shape[0]
    A, C, Q, R, mu0, S0 = (np.ascontiguousarray(m, np.float64) for m in (
        params.transition, params.observation, params.transition_cov,
        params.observation_cov, params.initial_mean, params.initial_cov))
    obs = np.ascontiguousarray(observations)
    miss = np.ascontiguousarray(missing.astype(np.uint8))
    out = {'means': np.empty((T, S)), 'covs': np.empty((T, S, S)),
           'pred_means': np.empty((T, S)), 'pred_covs': np.empty((T, S, S))}
    rc = native.load_kalman_library().kalman_filter_native(
        _as_c(A), _as_c(C), _as_c(Q), _as_c(R), _as_c(mu0), _as_c(S0),
        _as_c(obs), miss.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        T, S, O, _as_c(out['means']), _as_c(out['covs']), _as_c(out['pred_means']),
        _as_c(out['pred_covs']))
    if rc != 0:
        _native_failed('kalman_filter_native')
        return None
    return out


def kalman_filter(params: KalmanParams, observations, missing,
                  use_native: bool = False):
    '''Forward filter over (T, O) observations with per-timestep missing flags.

    The first timestep updates the prior (initial_mean/cov) directly like
    pykalman (no transition before t=0). Returns dict of filtered/predicted
    means and covariances. ``use_native`` runs the C++ core
    (``csrc/kalman_host.cpp``), which falls back to numpy on a failure.
    '''
    observations = np.asarray(observations, dtype=np.float64)
    missing = np.asarray(missing, dtype=bool)

    if use_native:
        out = _filter_native(params, observations, missing)
        if out is not None:
            return out
    A, C = params.transition, params.observation
    T = observations.shape[0]
    S_dim = A.shape[0]

    means = np.empty((T, S_dim))
    covs = np.empty((T, S_dim, S_dim))
    pred_means = np.empty((T, S_dim))
    pred_covs = np.empty((T, S_dim, S_dim))

    # t = 0: measurement update of the prior
    pred_means[0] = params.initial_mean
    pred_covs[0] = params.initial_cov
    if missing[0]:
        means[0], covs[0] = params.initial_mean, params.initial_cov
    else:
        innov = observations[0] - C @ params.initial_mean
        S = C @ params.initial_cov @ C.T + params.observation_cov
        K = np.linalg.solve(S, C @ params.initial_cov).T
        means[0] = params.initial_mean + K @ innov
        covs[0] = _symmetrize(params.initial_cov - K @ C @ params.initial_cov)

    for t in range(1, T):
        means[t], covs[t], pred_means[t], pred_covs[t] = kalman_filter_step(
            params, means[t - 1], covs[t - 1], observations[t], missing[t])

    return {'means': means, 'covs': covs,
            'pred_means': pred_means, 'pred_covs': pred_covs}


def kalman_smooth(params: KalmanParams, observations, missing,
                  use_native: bool = False, backend: Optional[str] = None):
    '''RTS smoother. Returns smoothed means/covs and lag-one covariances
    (V_{t+1, t | T} for t = 0..T-2) for EM.

    ``backend`` is one of ``'steady'`` (Riccati-converged fast path, no
    missing rows only), ``'numpy'``, ``'native'`` (the C++ core) or
    ``'scan'`` (:func:`kalman_smooth_scan`, the numpy recurrence); None
    takes ``native`` when ``use_native``, else ``steady`` when no row is
    missing, else ``MISSING_ROWS_BACKEND``.
    '''
    if backend is None:
        if use_native:
            backend = 'native'
        else:
            backend = 'steady' if not np.any(missing) else MISSING_ROWS_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f'unknown backend {backend!r}; one of {BACKENDS}')
    if backend == 'steady':
        if np.any(missing):
            raise ValueError("backend='steady' requires no missing rows")
        return kalman_smooth_steady(params, observations)
    use_native = backend == 'native'
    filt = kalman_filter(params, observations, missing, use_native=use_native)
    A = params.transition
    T = filt['means'].shape[0]
    S_dim = A.shape[0]

    if use_native and T >= 2:
        A_c = np.ascontiguousarray(A, np.float64)
        means = np.ascontiguousarray(filt['means'])
        covs = np.ascontiguousarray(filt['covs'])
        pred_means = np.ascontiguousarray(filt['pred_means'])
        pred_covs = np.ascontiguousarray(filt['pred_covs'])
        s_means = np.empty_like(means)
        s_covs = np.empty_like(covs)
        lag = np.empty((T - 1, S_dim, S_dim))
        rc = native.load_kalman_library().kalman_smooth_native(
            _as_c(A_c), _as_c(means), _as_c(covs), _as_c(pred_means),
            _as_c(pred_covs), T, S_dim, _as_c(s_means), _as_c(s_covs),
            _as_c(lag))
        if rc == 0:
            return {'means': s_means, 'covs': s_covs, 'lag_one_covs': lag,
                    'filtered': filt}
        _native_failed('kalman_smooth_native')

    s_means = np.empty_like(filt['means'])
    s_covs = np.empty_like(filt['covs'])
    lag_ones = np.empty((T - 1, S_dim, S_dim))
    s_means[-1] = filt['means'][-1]
    s_covs[-1] = filt['covs'][-1]

    # the smoother gains depend only on filtered quantities, so they batch
    # into one solve: J_t = f_cov_t A' P_{t+1|t}^{-1}; only the mean and
    # covariance recursions stay sequential
    if T >= 2:
        J_all = np.linalg.solve(
            filt['pred_covs'][1:],
            np.swapaxes(filt['covs'][:-1] @ A.T, 1, 2))
        J_all = np.ascontiguousarray(np.swapaxes(J_all, 1, 2))
        for t in range(T - 2, -1, -1):
            J = J_all[t]
            s_means[t] = filt['means'][t] + J @ (s_means[t + 1] - filt['pred_means'][t + 1])
            s_covs[t] = _symmetrize(
                filt['covs'][t] + J @ (s_covs[t + 1] - filt['pred_covs'][t + 1]) @ J.T)
            lag_ones[t] = s_covs[t + 1] @ J.T  # V_{t+1, t | T}

    return {'means': s_means, 'covs': s_covs, 'lag_one_covs': lag_ones,
            'filtered': filt}


def kalman_smooth_steady(params: KalmanParams, observations,
                         tol: float = 1e-12):
    '''RTS smoother exploiting Riccati convergence (no-missing fast path).

    With time-invariant params and no missing observations, the filter
    covariance sequence converges to a fixed point after a short transient
    (~50 steps at the 54-dim point tracker); the smoother covariances
    likewise converge backward from T. Covariances and gains are computed
    exactly through the transients and held at their converged values in
    between (below ``tol`` relative change), while the data-dependent mean
    recursions still run over every step. Same contract as
    :func:`kalman_smooth`.
    '''
    A, C = params.transition, params.observation
    Q, R = params.transition_cov, params.observation_cov
    obs = np.asarray(observations, np.float64)
    T = obs.shape[0]
    s_dim = A.shape[0]

    def update_cov(pp):
        innov_cov = C @ pp @ C.T + R
        gain = np.linalg.solve(innov_cov, C @ pp).T
        return gain, _symmetrize(pp - gain @ C @ pp)

    # forward covariances: exact until converged
    p_pred = [np.asarray(params.initial_cov, np.float64)]
    g0, pf0 = update_cov(p_pred[0])
    p_filt = [pf0]
    gains = [g0]
    k = T  # first index at which covariances are steady
    for t in range(1, T):
        pp = _symmetrize(A @ p_filt[-1] @ A.T + Q)
        gain, pf = update_cov(pp)
        p_pred.append(pp)
        p_filt.append(pf)
        gains.append(gain)
        if np.max(np.abs(pf - p_filt[-2])) <= tol * max(1.0, np.abs(pf).max()):
            k = t
            break
    pf_ss, pp_ss, k_ss = p_filt[-1], p_pred[-1], gains[-1]

    # forward means: per-step matvecs over all T
    f_means = np.empty((T, s_dim))
    pred_means = np.empty((T, s_dim))
    pred_means[0] = params.initial_mean
    f_means[0] = params.initial_mean + gains[0] @ (obs[0] - C @ params.initial_mean)
    for t in range(1, T):
        gain = gains[t] if t <= k else k_ss
        pm = A @ f_means[t - 1]
        pred_means[t] = pm
        f_means[t] = pm + gain @ (obs[t] - C @ pm)

    # materialized covariance sequences (steady beyond the transient)
    f_covs = np.empty((T, s_dim, s_dim))
    p_covs = np.empty((T, s_dim, s_dim))
    n_exact = len(p_filt)
    f_covs[:n_exact] = p_filt
    p_covs[:n_exact] = p_pred
    f_covs[n_exact:] = pf_ss
    p_covs[n_exact:] = pp_ss

    s_means = np.empty((T, s_dim))
    s_covs = np.empty((T, s_dim, s_dim))
    lag_ones = np.empty((max(T - 1, 0), s_dim, s_dim))
    s_means[-1] = f_means[-1]
    s_covs[-1] = f_covs[-1]

    if T >= 2:
        j_ss = np.linalg.solve(pp_ss, (pf_ss @ A.T).T).T
        j_exact = [np.linalg.solve(p_pred[t + 1], (p_filt[t] @ A.T).T).T
                   for t in range(n_exact - 1)]

        # backward covariances: exact until converged (moving back from T),
        # steady in the middle, exact again through the forward transient
        v_next = s_covs[-1]
        converged_at = None
        for t in range(T - 2, -1, -1):
            j_t = j_exact[t] if t < n_exact - 1 else j_ss
            if converged_at is None or t < n_exact - 1:
                v_t = _symmetrize(f_covs[t] + j_t @ (v_next - p_covs[t + 1]) @ j_t.T)
                lag_ones[t] = v_next @ j_t.T
                if (converged_at is None and t >= n_exact - 1
                        and np.max(np.abs(v_t - v_next))
                        <= tol * max(1.0, np.abs(v_t).max())):
                    converged_at = t
                    v_ss, lag_ss = v_t, v_t @ j_ss.T
                s_covs[t] = v_t
                v_next = v_t
            else:
                s_covs[t] = v_ss
                lag_ones[t] = lag_ss
                v_next = v_ss

        # backward means: per-step matvecs over all T
        for t in range(T - 2, -1, -1):
            j_t = j_exact[t] if t < n_exact - 1 else j_ss
            s_means[t] = f_means[t] + j_t @ (s_means[t + 1] - pred_means[t + 1])

    return {'means': s_means, 'covs': s_covs, 'lag_one_covs': lag_ones,
            'filtered': {'means': f_means, 'covs': f_covs,
                         'pred_means': pred_means, 'pred_covs': p_covs}}


def kalman_smooth_scan(params: KalmanParams, observations, missing):
    '''The reference's ``scan`` smoother (a jitted f64 ``lax.scan`` on the
    CPU): the same filter and RTS smoother, step for step, which here is the
    ``numpy`` backend. Same contract as :func:`kalman_smooth`.'''
    return kalman_smooth(params, observations, missing, backend='numpy')


def angle_intervention_filter(params: KalmanParams, mean0, cov0,
                              angles, align_scores, order: int = 3,
                              align_thresh: float = 0.4,
                              dev_thresh: float = 140.0):
    '''The angle-intervention recurrence, one f64 step per frame.

    For each frame: the angle tracker's 1-step-ahead prediction; if the
    keypoint alignment score is below ``align_thresh`` the angle defers to
    the prediction; else if the predicted-vs-observed deviation exceeds
    ``dev_thresh`` degrees the angle flips 180; the (possibly corrected)
    angle then drives a filter update, whose 2x2 innovation system is
    inverted analytically. NaN scores and deviations compare False, and a
    non-finite observation keeps the prediction.

    Returns (angles_out (T,), flip_deltas bool (T,), last_mean, last_cov).
    '''
    A, C, Q, R = (np.asarray(m, np.float64) for m in (
        params.transition, params.observation, params.transition_cov,
        params.observation_cov))
    mean = np.asarray(mean0, np.float64)
    cov = np.asarray(cov0, np.float64)
    angles = np.asarray(angles, np.float64)
    scores = np.asarray(align_scores, np.float64)
    n = angles.shape[0]
    out_angles = np.empty(n)
    flip_deltas = np.zeros(n, bool)
    AT, CT = A.T, C.T
    for t in range(n):
        angle, score = angles[t], scores[t]
        # sample(1): predicted next angle from the transition alone
        pred_state = A @ mean
        p_next = np.rad2deg(np.arctan2(pred_state[0], pred_state[order]))
        p_next = (p_next + 360.0 if p_next < 0 else p_next) % 360.0

        # smallest signed difference angle - p_next
        diff = (angle - p_next) % 360.0
        rel = diff - 360.0 if diff > 180.0 else diff

        low_align = score < align_thresh          # NaN -> False
        big_dev = abs(rel) > dev_thresh           # NaN -> False
        if low_align:
            angle_out = p_next
        elif big_dev:
            angle_out = (angle + 180.0) % 360.0
        else:
            angle_out = angle
        out_angles[t] = angle_out
        flip_deltas[t] = (not low_align) and big_dev

        # filter_update(angle_out): predict + 2D measurement update
        pred_cov = A @ cov @ AT + Q
        pred_cov = (pred_cov + pred_cov.T) / 2
        rad = np.deg2rad(angle_out)
        obs = np.array([np.sin(rad), np.cos(rad)])
        if not np.isfinite(obs).all():
            mean, cov = pred_state, pred_cov
            continue
        innov = obs - C @ pred_state
        S = C @ pred_cov @ CT + R                       # (2, 2)
        det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
        S_inv = np.array([[S[1, 1], -S[0, 1]],
                          [-S[1, 0], S[0, 0]]]) / det
        K = (pred_cov @ CT) @ S_inv
        mean = pred_state + K @ innov
        cov = pred_cov - K @ C @ pred_cov
        cov = (cov + cov.T) / 2
    return out_angles, flip_deltas, mean, cov


def _em_step(params: KalmanParams, observations, missing):
    sm = kalman_smooth(params, observations, missing)
    mu, V, lag = sm['means'], sm['covs'], sm['lag_one_covs']
    A, C = params.transition, params.observation
    T = observations.shape[0]

    # sufficient statistics, summed over time first (O(T S^2)):
    #   sum_t E[x_t x_t']     = sum_t V_t + M' M
    #   sum_t E[x_{t+1} x_t'] = sum_t lag_t + M[1:]' M[:-1]
    sum_Ext_head = V[:-1].sum(axis=0) + mu[:-1].T @ mu[:-1]
    sum_Ext_tail = V[1:].sum(axis=0) + mu[1:].T @ mu[1:]
    sum_Ext1 = lag.sum(axis=0) + mu[1:].T @ mu[:-1]

    # transition covariance: Q = mean(C_t - B_t A' - A B_t' + A D_t A')
    sum_B_At = sum_Ext1 @ A.T
    Q = (sum_Ext_tail - sum_B_At - sum_B_At.T
         + A @ sum_Ext_head @ A.T) / (T - 1)
    Q = _clip_psd(Q)

    # observation covariance over observed timesteps only
    obs_w = (~np.asarray(missing, bool)).astype(np.float64)
    resid = (np.asarray(observations, np.float64) - mu @ C.T) * obs_w[:, None]
    R_resid = resid.T @ resid
    V_w = np.tensordot(obs_w, V, axes=1)      # sum_t w_t V_t, (S, S)
    R_state = C @ V_w @ C.T
    nobs = max(obs_w.sum(), 1.0)
    R = _clip_psd((R_resid + R_state) / nobs)

    # initial state covariance
    d0 = mu[0] - params.initial_mean
    S0 = _clip_psd(V[0] + np.outer(d0, d0))

    return params._replace(transition_cov=Q, observation_cov=R, initial_cov=S0)


def kalman_em(params: KalmanParams, observations, missing, n_iter: int = 10) -> KalmanParams:
    '''EM for (transition_cov, observation_cov, initial_cov).'''
    observations = np.asarray(observations, dtype=np.float64)
    missing = np.asarray(missing, dtype=bool)
    for _ in range(n_iter):
        params = _em_step(params, observations, missing)
    return params


class KalmanTrackerItem:
    '''One tracked quantity: its blocks of the transition and observation
    matrices, its initial state and its data format.'''

    def __init__(self, order: int = 3, delta_t: float = 1.0):
        self.order = order
        self.delta_t = delta_t

    @property
    def state_size(self) -> int:
        '''Size of this item's state block.'''
        return np.atleast_2d(self.build_observ_mat()).shape[-1]

    def build_trans_mat(self) -> np.ndarray:
        '''Transition matrix block.'''
        raise NotImplementedError

    def build_observ_mat(self) -> np.ndarray:
        '''Observation matrix block.'''
        raise NotImplementedError

    def build_init_state_means(self, data: np.ndarray) -> np.ndarray:
        '''Initial state mean block.'''
        raise NotImplementedError

    def format_data(self, data: np.ndarray) -> np.ndarray:
        '''Map user data to observation columns.'''
        return data

    def inverse_format_data(self, data: np.ndarray) -> np.ndarray:
        '''Map state rows back to user data (keep every order-th column).'''
        return data[:, ::self.order]


class KalmanTrackerPoint1D(KalmanTrackerItem):
    '''Constant-jerk 1D point.'''

    def _derivatives(self):
        dt = self.delta_t
        return [1.0, dt, dt ** 2 / 2, dt ** 3 / 6][:self.order]

    def build_trans_mat(self):
        derivs = self._derivatives()
        mat = np.zeros((self.order, self.order))
        for d in range(self.order):
            for i, j in enumerate(range(d, self.order)):
                mat[d, j] = derivs[i]
        return mat

    def build_observ_mat(self):
        mat = np.zeros((self.order,))
        mat[0] = 1
        return mat

    def build_init_state_means(self, data: np.ndarray):
        means = np.zeros((self.order,))
        data = np.asarray(data)
        if data.shape[0] > 0:
            first = data[0]
            means[0] = first if np.isfinite(first) else 0.0
        return means


class KalmanTrackerPoint2D(KalmanTrackerPoint1D):
    '''Constant-jerk 2D point.'''

    def build_trans_mat(self):
        one = super().build_trans_mat()
        return block_diag(one, one)

    def build_observ_mat(self):
        one = super().build_observ_mat()
        return block_diag(one, one)

    def build_init_state_means(self, data: np.ndarray):
        return np.hstack((super().build_init_state_means(data[:, 0]),
                          super().build_init_state_means(data[:, 1])))


class KalmanTrackerAngle(KalmanTrackerPoint2D):
    '''Angle tracked on the unit circle as (sin, cos).'''

    def __init__(self, order: int = 3, delta_t: float = 1.0, degrees: bool = True):
        super().__init__(order=order, delta_t=delta_t)
        self.degrees = degrees

    def build_init_state_means(self, data: np.ndarray):
        return super().build_init_state_means(self.format_data(np.asarray(data)))

    def format_data(self, data: np.ndarray):
        data = np.asarray(data, dtype=float)
        if self.degrees:
            data = np.deg2rad(data)
        return np.column_stack([np.sin(data), np.cos(data)])

    def inverse_format_data(self, data: np.ndarray):
        data = data[:, ::self.order]
        angles = np.arctan2(data[:, 0], data[:, 1])
        angles = np.where(angles < 0, 2 * np.pi + angles, angles)
        if self.degrees:
            angles = np.rad2deg(angles)
        return angles


class KalmanTrackerNPoints2D(KalmanTrackerPoint2D):
    '''N 2D points tracked jointly.'''

    def __init__(self, n_points: int, order: int = 3, delta_t: float = 1.0):
        self.n_points = n_points
        super().__init__(order, delta_t)

    def build_trans_mat(self):
        one = super().build_trans_mat()
        return block_diag(*([one] * self.n_points))

    def build_observ_mat(self):
        one = super().build_observ_mat()
        return block_diag(*([one] * self.n_points))

    def build_init_state_means(self, data: np.ndarray):
        one_point = super().build_init_state_means
        return np.hstack([one_point(data[:, i, :]) for i in range(self.n_points)])

    def format_data(self, data: np.ndarray) -> np.ndarray:
        return np.asarray(data).reshape(data.shape[0], -1)

    def inverse_format_data(self, data: np.ndarray) -> np.ndarray:
        return data[:, ::self.order].reshape(data.shape[0], self.n_points, -1)


class KalmanTracker:
    '''Multi-item Kalman tracker: f64 params and the streaming state carried
    across chunks.'''

    def __init__(self, items_to_track: Sequence[KalmanTrackerItem]):
        if not items_to_track:
            raise ValueError('need at least one KalmanTrackerItem')
        timesteps = [item.delta_t for item in items_to_track]
        if not np.allclose(timesteps, timesteps[0]):
            raise ValueError('all items must share delta_t')
        self.items = list(items_to_track)
        self.params: Optional[KalmanParams] = None
        self.last_mean: Optional[np.ndarray] = None
        self.last_covar: Optional[np.ndarray] = None

    @property
    def is_initialized(self) -> bool:
        '''True once initialize() has run.'''
        return self.params is not None

    def _build_init_state_means(self, init_data):
        return np.hstack([item.build_init_state_means(np.asarray(init_data[i]))
                          for i, item in enumerate(self.items)])

    def _format_data(self, data):
        cols = [item.format_data(np.asarray(data[i], dtype=float))
                for i, item in enumerate(self.items)]
        return np.column_stack(cols)

    def _inverse_format_data(self, state_rows: np.ndarray) -> List[np.ndarray]:
        out = []
        offset = 0
        for item in self.items:
            out.append(item.inverse_format_data(state_rows[:, offset:offset + item.state_size]))
            offset += item.state_size
        return out

    def initialize(self, init_data: Sequence[np.ndarray]) -> None:
        '''Build the matrices and run EM (10 iterations) on the finite rows
        of ``init_data``.'''
        if len(init_data) != len(self.items):
            raise ValueError('init_data length must match items')

        A = block_diag(*[i.build_trans_mat() for i in self.items])
        C = block_diag(*[i.build_observ_mat() for i in self.items])
        S = A.shape[0]
        O = C.shape[0]
        mu0 = self._build_init_state_means(init_data)
        params = KalmanParams(
            transition=np.asarray(A, np.float64),
            observation=np.asarray(C, np.float64),
            transition_cov=np.eye(S),
            observation_cov=np.eye(O),
            initial_mean=np.asarray(mu0, np.float64),
            initial_cov=np.eye(S),
        )

        obs = self._format_data(init_data)
        finite_rows = np.isfinite(obs).all(axis=1)
        if finite_rows.sum() > 1:
            finite_obs = obs[finite_rows]
            missing = np.zeros((finite_obs.shape[0],), bool)
            params = kalman_em(params, finite_obs, missing, n_iter=10)

        self.params = params
        self.last_mean = np.asarray(params.initial_mean)
        self.last_covar = np.asarray(params.initial_cov)

    def _obs_and_missing(self, data):
        obs = self._format_data(data)
        missing = ~np.isfinite(obs).all(axis=1)
        obs = np.nan_to_num(obs, nan=0.0, posinf=0.0, neginf=0.0)
        return obs.astype(np.float64), missing

    def smooth(self, data: Sequence[np.ndarray]):
        '''Smooth a chunk; the streaming state stays as it is.'''
        obs, missing = self._obs_and_missing(data)
        return self._inverse_format_data(kalman_smooth(self.params, obs, missing)['means'])

    def smooth_update(self, data: Sequence[np.ndarray]):
        '''Smooth a chunk and carry the final state into the next chunk.'''
        obs, missing = self._obs_and_missing(data)
        if obs.shape[0] == 1:
            return self.filter_update(data)
        params = self.params._replace(initial_mean=np.asarray(self.last_mean, np.float64),
                                      initial_cov=np.asarray(self.last_covar, np.float64))
        sm = kalman_smooth(params, obs, missing)
        means = np.asarray(sm['means'])
        covs = np.asarray(sm['covs'])
        self.last_mean = means[-1]
        self.last_covar = covs[-1]
        self.params = self.params._replace(initial_mean=means[-1], initial_cov=covs[-1])
        return self._inverse_format_data(means)

    def filter(self, data: Sequence[np.ndarray]):
        '''Forward-filter a chunk; the streaming state stays as it is.'''
        obs, missing = self._obs_and_missing(data)
        return self._inverse_format_data(kalman_filter(self.params, obs, missing)['means'])

    def filter_update(self, data: Sequence[np.ndarray]):
        '''Streaming one-step filter update.'''
        obs, missing = self._obs_and_missing(data)
        mean, cov, _, _ = kalman_filter_step(
            self.params, np.asarray(self.last_mean, np.float64),
            np.asarray(self.last_covar, np.float64), obs[0], bool(missing[0]))
        self.last_mean = np.asarray(mean)
        self.last_covar = np.asarray(cov)
        return self._inverse_format_data(self.last_mean[None, :])

    def sample(self, n_timesteps: int = 1, init_data=None):
        '''Deterministic n-step-ahead mean prediction.'''
        if init_data is not None:
            state = self._build_init_state_means(init_data)
        else:
            state = np.asarray(self.last_mean)
        A = np.asarray(self.params.transition)
        for _ in range(n_timesteps):
            state = A @ state
        return self._inverse_format_data(state[None, :])
