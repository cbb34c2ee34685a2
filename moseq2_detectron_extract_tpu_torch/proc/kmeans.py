'''Mini-batch k-means: the clustering that ``generate-dataset --sample-method
kmeans`` picks its frames with.

The JAX package calls sklearn's ``MiniBatchKMeans(n_clusters=k, n_init=3,
random_state=0)`` (``dataset.py:select_frames_kmeans``); the card's machine
has no sklearn, so :func:`minibatch_kmeans` is that fit written out (sklearn
1.9's ``MiniBatchKMeans.fit`` with its defaults): ``batch_size`` 1024,
k-means++ on ``init_size = 3 * batch_size`` samples with ``2 + log(k)``
local trials, the best of 3 inits by inertia on a validation sample,
``max_iter`` 100, early stopping after ``max_no_improvement`` 10 steps
without a better smoothed inertia, and the reassignment of centres whose
counts fall below ``reassignment_ratio`` 0.01 of the largest; then labels
and inertia over all the data.

Every draw comes from ``np.random.RandomState(0)`` in sklearn's
order and with its arguments, so that the draws are sklearn's. The data and
the distances live on ``device``: the k-means++ distances are computed in
f64 and rounded to f32, as sklearn does for f32 data; the assignments use
an f32 ``torch.matmul`` for ``-2 X C^T + |C|^2``, as sklearn's BLAS call
does. Their sums run in another order than sklearn's, so a pick can differ
where two distances tie to within f32 rounding.
'''
from typing import Tuple

import numpy as np
import torch

# sklearn 1.9's MiniBatchKMeans(n_init=3, random_state=0) with its defaults
N_INIT = 3
RANDOM_STATE = 0
BATCH_SIZE = 1024
MAX_ITER = 100
MAX_NO_IMPROVEMENT = 10
REASSIGNMENT_RATIO = 0.01


def _sq_dists_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    '''(len(a), len(b)) squared distances, computed in f64 and rounded to f32,
    floored at 0 (sklearn's ``_euclidean_distances_upcast``).'''
    a64, b64 = a.double(), b.double()
    d = -2.0 * (a64 @ b64.T)
    d += (a64 * a64).sum(1, keepdim=True)
    d += (b64 * b64).sum(1)[None]
    return torch.clamp(d.float(), min=0.0)


def _labels(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    '''The nearest centre of each row (the first of equals), by
    ``-2 X C^T + |C|^2`` in f32.'''
    d = torch.addmm((centers * centers).sum(1)[None], x, centers.T, beta=1.0, alpha=-2.0)
    return torch.argmin(d, dim=1)


def _inertia(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor) -> float:
    '''Sum of squared distances of the rows to their centres.'''
    diff = x - centers[labels]
    return float((diff * diff).sum(1).double().sum())


def _kmeans_plusplus(x: torch.Tensor, k: int, rs: np.random.RandomState) -> torch.Tensor:
    '''sklearn's ``_kmeans_plusplus`` on unit weights.'''
    n = x.shape[0]
    weight = np.ones(n, np.float32)
    trials = 2 + int(np.log(k))
    first = rs.choice(n, p=weight / weight.sum())
    ids = [int(first)]
    closest = _sq_dists_f64(x[first:first + 1], x)[0].cpu().numpy()
    pot = closest @ weight
    for _ in range(1, k):
        rand_vals = rs.uniform(size=trials) * pot
        cands = np.searchsorted(np.cumsum(weight * closest), rand_vals)
        np.clip(cands, None, closest.size - 1, out=cands)
        dist = _sq_dists_f64(x[torch.as_tensor(cands, device=x.device)], x).cpu().numpy()
        np.minimum(closest, dist, out=dist)
        cand_pot = dist @ weight.reshape(-1, 1)
        best = int(np.argmin(cand_pot))
        pot = cand_pot[best]
        closest = dist[best]
        ids.append(int(cands[best]))
    return x[torch.as_tensor(ids, device=x.device)].clone()


def minibatch_kmeans(data: torch.Tensor, n_clusters: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    '''(centres (k, D), labels (N,), inertia) of sklearn's
    ``MiniBatchKMeans(n_clusters, n_init=3, random_state=0).fit`` on the f32
    (N, D) ``data`` (see the module).'''
    x = data.float().contiguous()
    n = x.shape[0]
    k = int(n_clusters)
    if not 1 <= k <= n:
        raise ValueError(f'{k} clusters for {n} samples')
    rs = np.random.RandomState(RANDOM_STATE)
    batch = min(BATCH_SIZE, n)
    init_size = 3 * batch
    if init_size < k:
        init_size = 3 * k
    init_size = min(init_size, n)

    valid_idx = rs.randint(0, n, init_size)
    x_valid = x[torch.as_tensor(valid_idx, device=x.device)]
    best_inertia, centers = None, None
    for _ in range(N_INIT):
        if init_size < n:
            init_idx = rs.randint(0, n, init_size)
            sub = x[torch.as_tensor(init_idx, device=x.device)]
        else:
            sub = x
        cand = _kmeans_plusplus(sub, k, rs)
        inertia = _inertia(x_valid, cand, _labels(x_valid, cand))
        if best_inertia is None or inertia < best_inertia:
            centers, best_inertia = cand, inertia

    counts = np.zeros(k, np.float32)
    ewa, ewa_min, no_improvement, since_reassign = None, None, 0, 0
    p = np.ones(n, np.float32)
    p = p / np.sum(p)
    n_steps = (MAX_ITER * n) // batch
    for step in range(n_steps):
        idx = rs.choice(n, batch, p=p, replace=True)
        since_reassign += batch
        reassign = bool((counts == 0).any()) or since_reassign >= 10 * k
        if reassign:
            since_reassign = 0
        xb = x[torch.as_tensor(idx, device=x.device)]
        labels = _labels(xb, centers)
        batch_inertia = _inertia(xb, centers, labels)
        # the centres move to the mean of their old weight and the new members
        member_counts = torch.bincount(labels, minlength=k)
        sums = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
        sums.index_add_(0, labels, xb.double())
        got = member_counts.cpu().numpy().astype(np.float32)
        hit = torch.as_tensor(got > 0, device=x.device)
        old = torch.as_tensor(counts, device=x.device).double()[:, None]
        counts = counts + got
        new = torch.as_tensor(counts, device=x.device).double()[:, None]
        moved = ((centers.double() * old + sums) / torch.clamp(new, min=1.0)).float()
        centers = torch.where(hit[:, None], moved, centers)
        if reassign:
            to_reassign = counts < REASSIGNMENT_RATIO * counts.max()
            if to_reassign.sum() > 0.5 * batch:
                to_reassign[np.argsort(counts)[int(0.5 * batch):]] = False
            n_reassign = int(to_reassign.sum())
            if n_reassign:
                picks = rs.choice(batch, replace=False, size=n_reassign)
                centers = centers.clone()
                centers[torch.as_tensor(np.flatnonzero(to_reassign), device=x.device)] = \
                    xb[torch.as_tensor(picks, device=x.device)]
            counts[to_reassign] = np.min(counts[~to_reassign])
        # early stopping on the smoothed batch inertia
        batch_inertia = np.float32(batch_inertia) / batch
        if step == 0:
            continue
        if ewa is None:
            ewa = batch_inertia
        else:
            alpha = min(batch * 2.0 / (n + 1), 1)
            ewa = ewa * (1 - alpha) + batch_inertia * alpha
        if ewa_min is None or ewa < ewa_min:
            no_improvement, ewa_min = 0, ewa
        else:
            no_improvement += 1
        if no_improvement >= MAX_NO_IMPROVEMENT:
            break

    labels = _labels(x, centers)
    return centers, labels, _inertia(x, centers, labels)


def nearest_members(data: torch.Tensor, centers: torch.Tensor,
                    labels: torch.Tensor) -> np.ndarray:
    '''For each centre in order, the row of its nearest member (the first of
    equals), or -1 when it has none.'''
    diff = data.float() - centers[labels]
    dist = torch.sqrt((diff * diff).sum(1)).cpu().numpy()
    labels_np = labels.cpu().numpy()
    out = np.full(centers.shape[0], -1, np.int64)
    for c in range(centers.shape[0]):
        members = np.flatnonzero(labels_np == c)
        if len(members):
            out[c] = members[np.argmin(dist[members])]
    return out
