'''Plane RANSAC over a depth image on the device.

Port of ``moseq2_detectron_extract_tpu/ops/ransac.py``: all hypothesis
triples are drawn up front, every candidate plane is scored with one
(P, 3) @ (3, iters) product, and the reference's sequential accept rule
(inlier ratio, strictly more inliers, strictly smaller mean distance) picks
the plane.

The draws are the JAX package's, bit for bit: ``jax.random.choice(
PRNGKey(seed), P, (iters, 3), p=valid / n_valid)`` is threefry2x32 uniform
floats mapped through the cumulative sum of ``p``, and both are written out
here in numpy. The cumulative sum follows the order of XLA's CPU rewrite of
the scan (prefix sums in blocks of 16, then the block totals the same way,
recursively), which is where the JAX reference runs off the TPU.
'''
from typing import Optional, Tuple

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.device import resolve_device

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SCAN_BLOCK = 16


def threefry2x32(key: Tuple[int, int], x1: np.ndarray, x2: np.ndarray):
    '''The Threefry-2x32 block cipher (20 rounds) of two uint32 words per
    element under ``key``, as JAX's ``threefry2x32`` computes it.'''
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]

    def rounds(rot):
        for r in rot:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]

    with np.errstate(over='ignore'):
        for i in range(5):
            rounds(_ROTATIONS[i % 2])
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def uniform(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    '''``jax.random.uniform(jax.random.PRNGKey(seed), shape)`` (f32 in [0, 1))
    with JAX's default, partitionable threefry: the key of a seed in
    [0, 2**32) is (0, seed), and the bits of element i are the two words of
    threefry2x32(key, (hi(i), lo(i))) xor-ed.'''
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f'seed {seed} outside [0, 2**32)')
    key = (0, seed)
    count = np.arange(int(np.prod(shape)), dtype=np.uint64)
    bits1, bits2 = threefry2x32(key, (count >> np.uint64(32)).astype(np.uint32),
                                (count & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = bits1 ^ bits2
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats).reshape(shape)


def xla_cumsum(x: np.ndarray) -> np.ndarray:
    '''f32 inclusive prefix sum in the order of XLA's CPU cumsum: sequential
    sums within blocks of 16, plus the exclusive prefix of the block totals
    (computed the same way).'''
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        return np.cumsum(x, dtype=np.float32)
    m = -(-n // _SCAN_BLOCK)
    rows = np.zeros(m * _SCAN_BLOCK, np.float32)
    rows[:n] = x
    pre = np.cumsum(rows.reshape(m, _SCAN_BLOCK), axis=1, dtype=np.float32)
    totals = xla_cumsum(pre[:, -1])
    before = np.concatenate([np.zeros(1, np.float32), totals[:-1]])
    return (pre + before[:, None]).ravel()[:n]


def weighted_choice(seed: int, probs: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    '''``jax.random.choice(PRNGKey(seed), len(probs), shape, p=probs)`` with
    replacement: indices by inverse CDF over the f32 cumulative sum.'''
    p_cuml = xla_cumsum(probs)
    r = p_cuml[-1] * (np.float32(1.0) - uniform(seed, shape))
    return np.searchsorted(p_cuml, r, side='left').astype(np.int64)


def _plane_from_3_points(points: torch.Tensor) -> torch.Tensor:
    '''(iters, 3, 3) point triples -> (iters, 4) planes [a, b, c, d] with a
    unit normal; NaN for degenerate triples.'''
    a = points[:, 1] - points[:, 0]
    b = points[:, 2] - points[:, 0]
    normal = torch.linalg.cross(a, b)
    denom = (normal * normal).sum(dim=1, keepdim=True)
    ok = denom >= 2.220446049250313e-16                      # np.spacing(1)
    normal = normal / torch.sqrt(torch.clamp(denom, min=1e-30))
    d = -(points[:, 0] * normal).sum(dim=1, keepdim=True)
    plane = torch.cat([normal, d], dim=1)
    return torch.where(ok, plane, torch.full_like(plane, float('nan')))


def plane_ransac(depth_image, depth_range=(650, 750), iters: int = 1000,
                 noise_tolerance: float = 30.0, in_ratio: float = 0.1,
                 mask: Optional[np.ndarray] = None, seed: int = 0, device='cuda'):
    '''RANSAC plane fit to an (H, W) depth image, over the pixels inside
    ``depth_range`` (and ``mask``).

    Returns ``plane`` ([a, b, c, d], numpy f32) and ``dists``, every pixel's
    absolute distance to it (flattened, numpy f32).
    '''
    dev = resolve_device(device)
    depth = torch.as_tensor(np.asarray(depth_image)).to(dev, torch.float32)
    h, w = depth.shape
    valid = (depth > depth_range[0]) & (depth < depth_range[1])
    if mask is not None:
        valid = valid & torch.as_tensor(np.asarray(mask, bool), device=dev)
    ygrid, xgrid = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                  torch.arange(w, dtype=torch.float32, device=dev),
                                  indexing='ij')
    coords = torch.stack([xgrid.reshape(-1), ygrid.reshape(-1), depth.reshape(-1)], dim=1)
    validf = valid.reshape(-1).float()
    npoints = torch.clamp(validf.sum(), min=1.0)

    probs = (validf / npoints).cpu().numpy()
    idx = torch.from_numpy(weighted_choice(seed, probs, (iters, 3))).to(dev)
    planes = _plane_from_3_points(coords[idx])                       # (iters, 4)
    bad = torch.isnan(planes).any(dim=1)
    safe = torch.where(bad[:, None], torch.zeros_like(planes), planes)

    dists_all = torch.abs(coords @ safe[:, :3].T + safe[None, :, 3]) * validf[:, None]
    ninliers = ((dists_all < noise_tolerance) & (validf[:, None] > 0)).sum(dim=0).float()
    mean_dist = dists_all.sum(dim=0) / npoints
    del dists_all

    # the sequential accept rule over the (iters,) scores, on the host
    ok = ((~bad) & (ninliers / npoints > in_ratio)).cpu().numpy()
    ninliers, mean_dist = ninliers.cpu().numpy(), mean_dist.cpu().numpy()
    best_idx, best_num, best_dist = 0, np.float32(0.0), np.float32(np.inf)
    for i in range(iters):
        if ok[i] and ninliers[i] > best_num and mean_dist[i] < best_dist:
            best_idx, best_num, best_dist = i, ninliers[i], mean_dist[i]
    best = safe[best_idx]
    dists = torch.abs(coords @ best[:3] + best[3])
    return best.cpu().numpy(), dists.cpu().numpy()
