'''Device ops of the extraction path in PyTorch, with the two hand-written
CUDA kernels (``roi_align_kernel``, ``clean_kernel``) beside their plain
PyTorch versions.

Exports the names of the JAX package's ``ops/__init__.py`` (``__all__``).
'''
from .cc import connected_components, largest_cc
from .instances import gather_selected, nms_and_centers, packbits_device, unpackbits_host
from .moments import mask_moment_features
from .morphology import (dilate, erode, make_ellipse_strel, make_rect_strel, median_blur_3x3,
                         morph_open)
from .nms import batched_nms_keep_mask, nms_keep_mask
from .preprocess import (fill_invalid_pixels, find_invalid_pixels, prep_raw_frames,
                         scale_raw_frames)
from .ransac import plane_ransac
from .roi_align import batched_multilevel_roi_align, multilevel_roi_align
from .warp import crop_and_rotate_frames, reverse_crop_and_rotate_frames

__all__ = ['dilate', 'erode', 'median_blur_3x3', 'morph_open', 'make_ellipse_strel',
           'make_rect_strel', 'fill_invalid_pixels', 'find_invalid_pixels', 'prep_raw_frames',
           'scale_raw_frames', 'mask_moment_features', 'connected_components', 'largest_cc',
           'crop_and_rotate_frames', 'reverse_crop_and_rotate_frames', 'plane_ransac',
           'nms_keep_mask', 'batched_nms_keep_mask', 'multilevel_roi_align',
           'batched_multilevel_roi_align', 'nms_and_centers', 'gather_selected',
           'packbits_device', 'unpackbits_host']
