'''Batched greedy NMS as a fixpoint of the suppression relation, and the
top-k of the kept boxes.

Port of ``moseq2_detectron_extract_tpu/ops/nms.py:20-81``: a box is kept iff
no higher-ranked kept box overlaps it above the threshold. Ranks order by
score, ties by index (the earlier index wins). The decided-state propagation
runs at most ``MAX_ITERS`` rounds, as the reference's bounded while loop.

:func:`nms_keep_mask` is the registered op ``m2de::nms_keep_mask``
(``torch.library.custom_op``). On a CUDA tensor it is one launch of the
CUDA kernel (``csrc/nms.cu``), which runs the rounds on the card with no
host sync and no (B, K, K) tensor, or it raises. On a CPU tensor it is the
plain version, :func:`nms_keep_mask_plain`, which asks the host after each
round whether a box is still undecided and stops when none is. Its fake
implementation gives the (B, K) bool shape, so that ``torch.export``
(``models/deploy.py``) records the op. The two keep masks are equal bit for
bit: the kernel computes the IoU in :func:`ops.boxes.pairwise_iou`'s
operations, and stops each image at its own convergence where the plain
version tests the whole batch, which gives the same answer since a round
after an image has converged changes nothing of its keep mask.
'''
import ctypes
import threading
from typing import NamedTuple

import torch

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.ops.boxes import pairwise_iou
from moseq2_detectron_extract_tpu_torch.utils.profiling import count

MAX_ITERS = 32
MAX_CLUSTER = 16      # CTAs of a thread-block cluster, one cluster an image
MAX_SMEM = 232448     # bytes of shared memory a block may use on sm_90
STAGE_BYTES = 16 * 64 * (16 + 8)   # the 16 warps' staged column boxes, scores and areas
# the most boxes an image: the staging and six vectors of an odd count of
# 64-bit words fit
MAX_K = 64 * (((MAX_SMEM - STAGE_BYTES) // 48 - 1) | 1)

# host syncs of the plain version's loop (one per round's convergence test)
# since the count was last set to 0; each is also the recorder's counter
# ``nms.sync``, credited to the open span (the proposal or the box NMS)
sync_count = 0
# launches of the CUDA kernel since the count was last set to 0; each is also
# the recorder's counter ``nms.kernel``
launch_count = 0
_count_lock = threading.Lock()


def _add_sync() -> None:
    '''Add one to ``sync_count`` under a lock: sessions on threads of one process
    count into it at once, and ``+=`` on a module global is not atomic.'''
    global sync_count
    with _count_lock:
        sync_count += 1
    count('nms.sync')


def _add_launch() -> None:
    '''Add one to ``launch_count`` under the same lock.'''
    global launch_count
    with _count_lock:
        launch_count += 1
    count('nms.kernel')


def dominance(boxes, scores, iou_threshold: float, valid):
    '''(..., K, K) bool: box j dominates box i (``[..., i, j]``) iff their
    IoU is above the threshold, j ranks before i and j is valid.'''
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    idx = torch.arange(k, device=boxes.device)
    s_i = scores[..., :, None]
    s_j = scores[..., None, :]
    rank_before = (s_j > s_i) | ((s_j == s_i) & (idx[None, :] < idx[:, None]))
    return (iou > iou_threshold) & rank_before & valid[..., None, :]


def nms_keep_mask_plain(boxes, scores, iou_threshold: float, valid):
    '''The plain fixpoint: keep mask over (..., K, 4) boxes with (..., K)
    scores and validity -> bool (..., K), a host sync a round.'''
    dominates = dominance(boxes, scores, iou_threshold, valid)
    keep = torch.zeros_like(valid)
    supp = torch.zeros_like(valid)
    for _ in range(MAX_ITERS):
        _add_sync()
        if not bool(torch.any(valid & ~keep & ~supp)):
            break
        keep = keep | (valid & ~supp & ~torch.any(dominates & ~supp[..., None, :], dim=-1))
        supp = supp | torch.any(dominates & keep[..., None, :], dim=-1)
    return keep


class NmsPlan(NamedTuple):
    '''How the kernel splits an image of K boxes: one cluster of ``cluster``
    CTAs, each owning the rows of ``words_per_cta`` 64-box words; a row of
    the dominance relation is ``row_words`` 64-bit words (the K / 64 words
    padded to an odd count); the bits live in shared memory or, where a
    CTA's slice does not fit, in a device-memory scratch.'''
    words: int
    row_words: int
    cluster: int
    words_per_cta: int
    bits_in_smem: bool
    smem_bytes: int


def launch_plan(k: int) -> NmsPlan:
    '''The most CTAs a cluster (at most ``MAX_CLUSTER``, never an empty
    one), and the bits in shared memory where the CTA's slice fits beside
    the six vectors (valid, finite, and keep and supp of two parities) and
    the warps' staged columns, as ``csrc/nms.cu:smem_bytes`` counts them.
    Raises above ``MAX_K``, where even the vectors do not fit.'''
    if k < 1:
        raise ValueError(f'no boxes (K = {k})')
    if k > MAX_K:
        raise ValueError(f'the NMS kernel takes at most {MAX_K} boxes an image, got {k}')
    words = -(-k // 64)
    row_words = words | 1
    words_per_cta = -(-words // min(MAX_CLUSTER, words))
    cluster = -(-words // words_per_cta)
    vectors = 8 * 6 * row_words + STAGE_BYTES
    bits = 8 * 64 * words_per_cta * row_words
    in_smem = vectors + bits <= MAX_SMEM
    return NmsPlan(words, row_words, cluster, words_per_cta, in_smem,
                   vectors + (bits if in_smem else 0))


def nms_keep_mask_cuda(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    '''Launch the kernel: (B, K, 4) float32 boxes, (B, K) float32 scores and
    bool validity, contiguous, on one card -> bool (B, K), on the current
    stream.'''
    device = boxes.device
    if device.type != 'cuda':
        raise ValueError('nms_keep_mask_cuda needs CUDA tensors')
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError('boxes must be a (B, K, 4) float32 tensor')
    b, k = boxes.shape[:2]
    for name, t, dtype in (('scores', scores, torch.float32), ('valid', valid, torch.bool)):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != (b, k):
            raise ValueError(f'{name} must be a ({b}, {k}) {dtype} tensor on {device}')
    if b > 65535:
        raise ValueError(f'the NMS kernel takes at most 65,535 images, got {b}')
    boxes, scores, valid = (t.contiguous() for t in (boxes, scores, valid))
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()                     # float4 loads
    keep = torch.empty((b, k), dtype=torch.bool, device=device)
    if b * k == 0:
        return keep
    plan = launch_plan(k)
    scratch = None if plan.bits_in_smem else torch.empty(
        (b, plan.cluster, 64 * plan.words_per_cta, plan.row_words), dtype=torch.int64,
        device=device)
    lib = native.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.m2de_nms_keep_mask(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
                                    keep.data_ptr(),
                                    None if scratch is None else scratch.data_ptr(),
                                    b, k, plan.cluster, plan.words_per_cta,
                                    int(plan.bits_in_smem), ctypes.c_float(iou_threshold),
                                    MAX_ITERS, stream)
    native.check(rc, 'nms kernel launch')
    _add_launch()
    return keep


@torch.library.custom_op('m2de::nms_keep_mask', mutates_args=(), device_types='cuda')
def keep_mask_op(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    '''The registered op on CUDA tensors: one launch of the kernel
    (:func:`nms_keep_mask_cuda`, with its checks and its launch count).'''
    return nms_keep_mask_cuda(boxes, scores, valid, iou_threshold)


@keep_mask_op.register_kernel('cpu')
def _keep_mask_cpu(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    return nms_keep_mask_plain(boxes, scores, iou_threshold, valid)


@keep_mask_op.register_fake
def _keep_mask_fake(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    return scores.new_empty(scores.shape, dtype=torch.bool)


def nms_keep_mask(boxes, scores, iou_threshold: float, valid=None):
    '''Keep mask over (B, K, 4) boxes with (B, K) scores -> bool (B, K).

    ``valid`` masks out padding boxes (treated as suppressed). Any leading
    shape in place of B is taken; the mask carries no gradient.
    '''
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    k = boxes.shape[-2]
    keep = keep_mask_op(boxes.detach().reshape(-1, k, 4), scores.detach().reshape(-1, k),
                        valid.reshape(-1, k), float(iou_threshold))
    return keep.reshape(scores.shape)


def batched_nms_keep_mask(boxes, scores, idxs, iou_threshold: float, valid=None):
    '''Category-aware NMS over (B, K): boxes of different ``idxs`` never
    suppress each other (per-image coordinate offsets).'''
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    max_coord = finite.flatten(-2).amax(dim=-1) + 1.0             # (B,)
    offsets = idxs.to(boxes.dtype) * (max_coord[..., None] + 1.0)
    shifted = boxes + offsets[..., None]
    return nms_keep_mask(shifted, scores, iou_threshold, valid=valid)


def stable_topk(values, k: int):
    '''Top-``k`` along the last axis, ties in index order (``lax.top_k``).

    ``torch.topk`` does not promise an order for ties; a stable descending
    sort does.
    '''
    sorted_vals, order = torch.sort(values, dim=-1, descending=True, stable=True)
    return sorted_vals[..., :k], order[..., :k]


def topk_after_nms(boxes, scores, keep, k: int):
    '''The top-``k`` kept boxes of (K, 4) ``boxes`` by score, ties to the
    lower index, zero-padded where fewer than ``k`` are kept: (boxes (k, 4),
    scores (k,), valid (k,), idx (k,)).'''
    masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    top_scores, top_idx = stable_topk(masked, k)
    top_valid = torch.isfinite(top_scores)
    return (torch.where(top_valid[:, None], boxes[top_idx], torch.zeros_like(boxes[top_idx])),
            torch.where(top_valid, top_scores, torch.zeros_like(top_scores)),
            top_valid, top_idx)
