'''ROI discovery: the background image, and the arena's floor found by a
plane RANSAC and ranked among the connected regions.

Port of ``moseq2_detectron_extract_tpu/proc/roi.py`` (``get_bground_im``,
``get_roi``). The median filters, the RANSAC and the dilation run on the
device; labelling, ranking and hole filling run once per session on the
host with scipy.
'''
from typing import Optional, Tuple

import numpy as np
import scipy.ndimage
import torch

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.ops.morphology import (dilate, erode, median_blur,
                                                               select_strel)
from moseq2_detectron_extract_tpu_torch.ops.ransac import plane_ransac

# 8-connectivity, as skimage.measure.label's default for 2-D
_LABEL_STRUCTURE = np.ones((3, 3), dtype=int)


def rank_max(values: np.ndarray) -> np.ndarray:
    '''``scipy.stats.rankdata(values, method='max')``: each value's count of
    values at most it (1-based ranks, ties at their highest rank).'''
    values = np.asarray(values)
    return np.searchsorted(np.sort(values), values, side='right').astype('float64')


def get_bground_im(frames: np.ndarray, med_scale: int = 5, device='cuda') -> np.ndarray:
    '''Per-pixel temporal median of the ``med_scale``-median-blurred frames
    (f32). With an even count it is the mean of the two middle values, as
    ``jnp.median`` gives it: their f32 sum halved, exact for depth values.'''
    dev = resolve_device(device)
    blurred = median_blur(torch.as_tensor(np.asarray(frames)).to(dev), med_scale)
    ordered = torch.sort(blurred.float(), dim=0).values
    n = ordered.shape[0]
    return ((ordered[(n - 1) // 2] + ordered[n // 2]) * 0.5).cpu().numpy()


def get_roi(depth_image: np.ndarray,
            dilate_size: Tuple[int, int] = (10, 10), dilate_shape: str = 'ellipse',
            erode_size: Optional[Tuple[int, int]] = None, erode_shape: str = 'ellipse',
            noise_tolerance: float = 30.0, weights: Tuple[float, float, float] = (1, .1, 1),
            depth_range: Tuple[float, float] = (650, 750),
            gradient_filter: bool = False, gradient_threshold: float = 3000,
            gradient_kernel: int = 7, fill_holes: bool = True,
            iters: int = 1000, in_ratio: float = 0.1, seed: int = 0, device='cuda'):
    '''Candidate ROIs of a background image: the pixels within
    ``noise_tolerance`` of the RANSAC plane, split into 8-connected regions
    and sorted by the weighted ranks of (area, extent, farthest distance
    from the centre); each dilated, eroded and hole-filled as asked.

    Returns ``(rois, plane)``: a list of boolean masks and [a, b, c, d].
    '''
    dev = resolve_device(device)
    depth_image = np.asarray(depth_image, dtype='float64')

    mask = None
    if gradient_filter:
        gy, gx = np.gradient(depth_image)
        # the reference uses Sobel(ksize=gradient_kernel); central differences
        # scaled to a comparable magnitude serve the same wall exclusion
        scale = 2.0 ** (2 * gradient_kernel - 3) / 8.0
        mask = np.logical_and(np.abs(gx) * scale < gradient_threshold,
                              np.abs(gy) * scale < gradient_threshold)

    plane, dists = plane_ransac(depth_image, depth_range=depth_range, iters=iters,
                                noise_tolerance=noise_tolerance, in_ratio=in_ratio,
                                mask=mask, seed=seed, device=dev)
    dist_im = dists.reshape(depth_image.shape)
    if mask is not None:
        dist_im[~mask] = np.inf
    bin_im = dist_im < noise_tolerance

    labels, nlabels = scipy.ndimage.label(bin_im, structure=_LABEL_STRUCTURE)
    if nlabels == 0:
        return [np.zeros_like(bin_im)], plane

    center = np.array(depth_image.shape) / 2
    areas = np.zeros(nlabels)
    extents = np.zeros(nlabels)
    cdists = np.zeros(nlabels)
    slices = scipy.ndimage.find_objects(labels)
    for i in range(nlabels):
        region = labels == (i + 1)
        areas[i] = region.sum()
        sl = slices[i]
        bbox_area = (sl[0].stop - sl[0].start) * (sl[1].stop - sl[1].start)
        extents[i] = areas[i] / max(bbox_area, 1)
        ys, xs = np.nonzero(region)
        cdists[i] = np.sqrt(((ys - center[0]) ** 2 + (xs - center[1]) ** 2)).max()

    ranks = np.vstack((rank_max(-areas), rank_max(-extents), rank_max(cdists)))
    weight_array = np.array(weights, 'float32')
    shape_index = np.mean(ranks.astype('float32') * weight_array[:, None], 0).argsort()

    rois = []
    for shape in shape_index:
        roi = (labels == (shape + 1)).astype('uint8')
        if dilate_size is not None and min(dilate_size) > 0:
            strel = select_strel(dilate_shape, tuple(dilate_size))
            roi = dilate(torch.from_numpy(roi[None]).to(dev), strel, 1)[0].cpu().numpy()
        if erode_size is not None and min(erode_size) > 0:
            strel = select_strel(erode_shape, tuple(erode_size))
            roi = erode(torch.from_numpy(roi[None]).to(dev), strel, 1)[0].cpu().numpy()
        if fill_holes:
            roi = scipy.ndimage.binary_fill_holes(roi > 0)
        rois.append(np.asarray(roi) > 0)
    return rois, plane
