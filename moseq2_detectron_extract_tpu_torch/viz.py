'''The preview's views, and the two preview commands' renderers.

Port of ``moseq2_detectron_extract_tpu/viz.py``: the video helpers
(``colorize_video``, ``stack_videos``, lines 34-98), the keypoint drawing
(``_chan``, ``draw_keypoints``, ``_skeleton_idx``,
``precompute_keypoint_draws``, ``draw_keypoints_fast``, lines 105-187),
the single-image views of annotations and predictions
(``draw_mask_contour``, ``draw_instances``, ``draw_annotation_item``,
``visualize_annotations``, ``visualize_inference``, lines 187-299),
``_gray_chunk_to_rgb`` (306; ``_blend_mask``, 328, is
``ops/draw.py:blend_mask``), the three views
(``ArenaView``, ``RotatedKeypointsView``, ``CleanedFramesView``, 363-549),
``generate_raw_preview`` (552-575) and ``H5ResultPreviewVideoGenerator``
(578-642).

The JAX package draws with cv2 and skips every overlay where cv2 is
missing; the port always draws, with ``ops/draw.py`` (cv2 5.0's pixels,
through its C++ core: a view records a block's primitives in a
``DrawList`` and draws them in one call; the single-image views draw
their keypoints so too, and their contours, text and boxes through the
plain versions). The contours of the ROI and of masks come
from ``io/annot.py:mask_to_poly`` (``cv2.findContours`` written out).
``visualize_annotations`` returns matplotlib's ``(fig, axs)`` where
matplotlib imports, else the stacked RGB array, as the JAX function does.
Videos are written by ``io/video.py:PreviewVideoWriter`` as Motion-JPEG
AVIs: ``preview.avi`` and ``<results>.preview.avi`` where the JAX package
writes ``.mp4``.
'''
import logging
import os
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.io import hdf5
from moseq2_detectron_extract_tpu_torch.io.annot import mask_to_poly, poly_to_mask
from moseq2_detectron_extract_tpu_torch.io.image import read_image
from moseq2_detectron_extract_tpu_torch.io.session import Session, Stream
from moseq2_detectron_extract_tpu_torch.io.video import PreviewVideoWriter, apply_colormap_jet
from moseq2_detectron_extract_tpu_torch.ops import draw
from moseq2_detectron_extract_tpu_torch.ops.draw import DrawList
from moseq2_detectron_extract_tpu_torch.ops.preprocess import prep_raw_frames
from moseq2_detectron_extract_tpu_torch.ops.warp import reverse_crop_and_rotate_frames
from moseq2_detectron_extract_tpu_torch.proc.keypoints import (default_keypoint_colors,
                                                               default_keypoint_connection_rules,
                                                               default_keypoint_names)


def colorize_video(frames: np.ndarray, vmin: float = 0, vmax: float = 100,
                   cmap: str = 'jet') -> np.ndarray:
    '''Single-channel video (N, H, W) -> uint8 RGB (N, H, W, 3), jet only.'''
    del cmap
    return apply_colormap_jet(np.asarray(frames), vmin, vmax)


def stack_videos(videos, orientation: str = 'horizontal',
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    '''Stack equal-length colour videos into one (horizontal, vertical or
    'diagional', the reference's spelling). ``out`` reuses a buffer; its
    padding is zeroed on each call.'''
    videos = [np.asarray(v) for v in videos]
    nframes = videos[0].shape[0]
    channels = videos[0].shape[3]
    if any(v.shape[0] != nframes or v.shape[3] != channels for v in videos):
        raise ValueError('videos must share frame count and channel count')
    heights = [v.shape[1] for v in videos]
    widths = [v.shape[2] for v in videos]
    if orientation == 'horizontal':
        height, width = max(heights), sum(widths)
    elif orientation == 'vertical':
        height, width = sum(heights), max(widths)
    elif orientation == 'diagional':
        height, width = sum(heights), sum(widths)
    else:
        raise ValueError(f'Unknown orientation "{orientation}"')

    reused = out is not None
    if reused:
        expect = (nframes, height, width, channels)
        if out.shape != expect or out.dtype != videos[0].dtype:
            raise ValueError(f'out must be {expect} {videos[0].dtype}, '
                             f'got {out.shape} {out.dtype}')
    else:
        out = np.zeros((nframes, height, width, channels), videos[0].dtype)
    off_h = off_w = 0
    for v in videos:
        if orientation == 'horizontal':
            out[:, :v.shape[1], off_w:off_w + v.shape[2]] = v
            if reused and v.shape[1] < height:
                out[:, v.shape[1]:, off_w:off_w + v.shape[2]] = 0
            off_w += v.shape[2]
        elif orientation == 'vertical':
            out[:, off_h:off_h + v.shape[1], :v.shape[2]] = v
            if reused and v.shape[2] < width:
                out[:, off_h:off_h + v.shape[1], v.shape[2]:] = 0
            off_h += v.shape[1]
        else:
            if reused:
                out[:, off_h:off_h + v.shape[1], :off_w] = 0
                out[:, off_h:off_h + v.shape[1], off_w + v.shape[2]:] = 0
            out[:, off_h:off_h + v.shape[1], off_w:off_w + v.shape[2]] = v
            off_h += v.shape[1]
            off_w += v.shape[2]
    return out


_DEFAULT_NAME_TO_IDX = {n: i for i, n in enumerate(default_keypoint_names)}


def _chan(color, order: str):
    '''A draw colour in the image's channel order.'''
    return tuple(color[::-1]) if order == 'bgr' else tuple(color)


def draw_keypoints(image: np.ndarray, keypoints: np.ndarray,
                   names: Optional[Sequence[str]] = None,
                   draw_skeleton: bool = True, order: str = 'rgb') -> np.ndarray:
    '''Keypoint dots (radius 2, anti-aliased) and the skeleton's lines onto
    one C-contiguous uint8 colour image, in place; non-finite points are
    skipped.'''
    name_to_idx = _DEFAULT_NAME_TO_IDX if names is None else \
        {n: i for i, n in enumerate(names)}
    draws = DrawList()
    kp = np.atleast_2d(keypoints)
    for ki, (x, y, *_) in enumerate(kp):
        if np.isfinite(x) and np.isfinite(y):
            color = _chan(default_keypoint_colors[ki % len(default_keypoint_colors)], order)
            draws.circle(0, (int(round(x)), int(round(y))), 2, color)
    if draw_skeleton:
        for a, b, color in default_keypoint_connection_rules:
            if a not in name_to_idx or b not in name_to_idx:
                continue
            pa, pb = kp[name_to_idx[a]], kp[name_to_idx[b]]
            if np.isfinite(pa[:2]).all() and np.isfinite(pb[:2]).all():
                draws.line(0, (int(round(pa[0])), int(round(pa[1]))),
                           (int(round(pb[0])), int(round(pb[1]))), _chan(color, order))
    draws.draw(image[None])
    return image


_SKELETON_IDX = None


def _skeleton_idx():
    '''[(ia, ib, colour)] of the skeleton for the default names.'''
    global _SKELETON_IDX
    if _SKELETON_IDX is None:
        _SKELETON_IDX = [
            (_DEFAULT_NAME_TO_IDX[a], _DEFAULT_NAME_TO_IDX[b], color)
            for a, b, color in default_keypoint_connection_rules
            if a in _DEFAULT_NAME_TO_IDX and b in _DEFAULT_NAME_TO_IDX]
    return _SKELETON_IDX


def precompute_keypoint_draws(keypoints: np.ndarray, order: str = 'rgb'):
    '''A block's (N, K, 2+) keypoints rounded and checked once: (pts, fin,
    colors, skeleton), pts and fin as nested lists.'''
    kp = np.asarray(keypoints)
    xy = kp[..., :2].astype(np.float64)
    fin = np.isfinite(xy).all(axis=-1)
    pts = np.round(np.nan_to_num(xy)).astype(np.int32).tolist()
    colors = [_chan(default_keypoint_colors[ki % len(default_keypoint_colors)], order)
              for ki in range(kp.shape[1])]
    skeleton = [(ia, ib, _chan(c, order)) for ia, ib, c in _skeleton_idx()]
    return pts, fin.tolist(), colors, skeleton


def draw_keypoints_fast(draws: DrawList, frame: int, pts, fin, colors, skeleton,
                        draw_skeleton: bool = True) -> DrawList:
    '''One frame's keypoints from ``precompute_keypoint_draws`` as records
    of ``draws`` (``draw_keypoints`` with the default names).'''
    for ki, ok in enumerate(fin):
        if ok:
            draws.circle(frame, pts[ki], 2, colors[ki])
    if draw_skeleton:
        for ia, ib, color in skeleton:
            if fin[ia] and fin[ib]:
                draws.line(frame, pts[ia], pts[ib], color)
    return draws


def draw_mask_contour(image: np.ndarray, mask: np.ndarray,
                      color=(255, 255, 255)) -> np.ndarray:
    '''Outline a boolean mask's external contours on an RGB image in place
    (anti-aliased, one pixel wide).'''
    draw.draw_contours_aa(image, mask_to_poly(np.asarray(mask, np.uint8)), color)
    return image


def draw_instances(image: np.ndarray, masks: np.ndarray, keypoints: np.ndarray,
                   scores: Optional[np.ndarray] = None) -> np.ndarray:
    '''Each instance's mask outline, keypoints and (where ``scores`` are
    given) its score with two decimals at the mask's top-left, in place.'''
    for d in range(len(masks)):
        draw_mask_contour(image, masks[d])
        draw_keypoints(image, keypoints[d])
        if scores is not None:
            ys, xs = np.nonzero(masks[d])
            if len(ys):
                draw.put_text(image, f'{scores[d]:.2f}', (int(xs.min()), int(ys.min())),
                              'score', (255, 255, 255))
    return image


def draw_annotation_item(item: Dict) -> np.ndarray:
    '''One annotated dataset item as RGB uint8: the image scaled by its
    ``rescale_intensity``, each instance's mask blended and outlined, its
    keypoints and its box. A segmentation is a mask array or a Label
    Studio polygon list.'''
    image = np.atleast_3d(read_image(item['file_name']))[:, :, 0]
    scale_factor = item.get('rescale_intensity') or 1
    image = np.clip(image.astype('float32') * scale_factor, 0, 255)
    rgb = _gray_chunk_to_rgb(image.astype('uint8')[None])[0]
    h, w = rgb.shape[:2]
    for annot in item.get('annotations', []):
        seg = annot.get('segmentation')
        if seg is not None:
            if isinstance(seg, np.ndarray) and seg.dtype != object:
                mask = np.atleast_3d(seg)[:, :, 0].astype(bool)
            else:
                poly = np.reshape(np.asarray(seg[0], float), (-1, 2))
                mask = poly_to_mask(poly, (h, w))[..., 0].astype(bool)
            draw.blend_mask(rgb, mask, color=(0, 120, 255), alpha=0.35)
            draw_mask_contour(rgb, mask, color=(0, 200, 255))
        kp = np.asarray(annot.get('keypoints', []), float).reshape(-1, 3)
        if kp.size:
            draw_keypoints(rgb, kp[:, :2])
        box = annot.get('bbox')
        if box is not None:
            x0, y0, x1, y1 = [int(round(v)) for v in box]
            draw.rectangle(rgb, (x0, y0), (x1, y1), (0, 255, 0))
    return rgb


def visualize_annotations(annotations: Sequence[Dict], num: int = 5,
                          seed: Optional[int] = None):
    '''``num`` items drawn by ``random.Random(seed).sample``, each by
    :func:`draw_annotation_item`: ``(fig, axs)`` of one matplotlib row
    where matplotlib imports, else the renderings stacked side by side.'''
    num = min(num, len(annotations))
    sampled = random.Random(seed).sample(list(annotations), num)
    rendered = [draw_annotation_item(item) for item in sampled]
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return stack_videos([r[None] for r in rendered], orientation='horizontal')[0]
    fig, axs = plt.subplots(1, num, figsize=(4 * num, 4), squeeze=False)
    for image, ax in zip(rendered, axs[0]):
        ax.imshow(image)
        ax.axis('off')
    return fig, axs[0]


def _host(value) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def visualize_inference(frame, prediction: Dict, min_height: float, max_height: float,
                        scale: float = 2.0) -> np.ndarray:
    '''One prediction drawn over its depth frame, as RGB uint8: ``frame``
    (H, W) in mm, normalised by [min_height, max_height]; ``prediction`` a
    Predictor-style dict of one frame (masks (D, H, W), keypoints (D, K, 3),
    scores (D,), valid (D,)), numpy arrays or tensors on any device; the
    valid instances drawn by :func:`draw_instances`; the image resized by
    ``scale`` (linear).'''
    norm = (_host(frame).astype('float32') - min_height) / max(max_height - min_height, 1e-9)
    gray = (np.clip(norm, 0, 1) * 255).astype('uint8')
    rgb = _gray_chunk_to_rgb(gray[None])[0]
    masks = _host(prediction['masks'])
    valid = _host(prediction['valid']).astype(bool) if 'valid' in prediction else \
        np.ones(len(masks), bool)
    scores = prediction.get('scores')
    draw_instances(rgb, masks[valid], _host(prediction['keypoints'])[valid],
                   _host(scores)[valid] if scores is not None else None)
    if scale != 1.0:
        rgb = draw.resize_linear(rgb, (int(rgb.shape[1] * scale), int(rgb.shape[0] * scale)))
    return rgb


def _gray_chunk_to_rgb(frames: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    '''(N, H, W) uint8 -> (N, H, W, 3), each channel the gray value.'''
    frames = np.asarray(frames)
    if out is None:
        out = np.empty(frames.shape + (3,), np.uint8)
    out[...] = frames[..., None]
    return out


class ArenaView:
    '''The arena: depth frames in gray, the ROI's outline, and each frame's
    instance (mask fill, boxes with their index, keypoints and skeleton).'''

    def __init__(self, roi: Optional[np.ndarray], vmin: float = 0, vmax: float = 100,
                 scale: float = 1.0, order: str = 'rgb'):
        self.vmin = vmin
        self.vmax = vmax
        self.scale = scale
        self.order = order
        self.contours = None
        self._stamp = None
        if roi is not None:
            roi = np.asarray(roi)
            ys, xs = np.nonzero(roi > 0)
            cropped = roi[ys.min():ys.max() + 1, xs.min():xs.max() + 1] if len(ys) else roi
            self.contours = mask_to_poly((cropped > 0).astype('uint8'))

    def render(self, frames: np.ndarray, masks: Optional[np.ndarray] = None,
               keypoints: Optional[np.ndarray] = None, boxes: Optional[np.ndarray] = None,
               out: Optional[np.ndarray] = None, mask_crops: Optional[np.ndarray] = None,
               mask_origins: Optional[np.ndarray] = None) -> np.ndarray:
        '''frames (N, H, W) uint8; masks (N, H, W), or ``mask_crops`` (N, c,
        c) at ``mask_origins`` (N, 2 [y0, x0]); keypoints (N, K, 3) and
        boxes (N, B, 4) or (N, 4) in arena px (NaN boxes skipped). ``out``
        (N, H, W, 3), used at scale 1, reuses a buffer.'''
        video = _gray_chunk_to_rgb(frames, out=out if self.scale == 1.0 else None)
        n, h, w = frames.shape
        s = self.scale
        if s != 1.0:
            video = draw.resize_linear_block(video, (int(w * s), int(h * s)))
        if self.contours is not None:
            ys, xs, alpha = self._contour_stamp(video.shape[1], video.shape[2])
            px = video[:, ys, xs].astype(np.float32)
            px += alpha * (np.array((0, 255, 0), np.float32) - px)
            video[:, ys, xs] = (px + 0.5).astype(np.uint8)
        mask_color = _chan((0, 0, 255), self.order)
        use_crops = masks is None and mask_crops is not None
        if use_crops and s != 1.0:
            full = np.zeros((len(mask_crops), h, w), np.uint8)
            c = mask_crops.shape[1]
            for i, (y0, x0) in enumerate(np.asarray(mask_origins)):
                full[i, y0:y0 + c, x0:x0 + c] = mask_crops[i]
            masks, use_crops = full, False
        if use_crops:
            draw.blend_windows(video, mask_crops, mask_origins, mask_color, 0.3)
        elif masks is not None:
            draw.blend_windows(video, masks, None, mask_color, 0.3)
        draws = DrawList()
        if boxes is not None:
            bx = np.asarray(boxes, np.float64)
            if bx.ndim == 2:
                bx = bx[:, None, :]
            bx = bx * s
            box_ok = (~np.isnan(bx).any(axis=-1)).tolist()
            box_pts = np.nan_to_num(bx).astype(np.int32).tolist()
        kp_draw = None
        if keypoints is not None:
            kp_draw = precompute_keypoint_draws(np.asarray(keypoints) * [s, s, 1],
                                                order=self.order)
        for i in range(n):
            if boxes is not None:
                for b, box in enumerate(box_pts[i]):
                    if box_ok[i][b]:
                        draws.rectangle(i, box[0:2], box[2:4], (0, 255, 0))
                        draws.number(i, b, box[0:2], 'index', (255, 255, 255))
            if kp_draw is not None:
                draw_keypoints_fast(draws, i, kp_draw[0][i], kp_draw[1][i], kp_draw[2],
                                    kp_draw[3])
        draws.draw(video)
        return video

    def _contour_stamp(self, h: int, w: int):
        '''(ys, xs, alpha) of the scaled ROI outline, drawn once (255 on
        black, so the level is the coverage).'''
        if self._stamp is None or self._stamp[0] != (h, w):
            canvas = np.zeros((1, h, w), np.uint8)
            outline = DrawList()
            outline.contours(0, [np.round(c * self.scale).astype(np.int32)
                                 for c in self.contours], (255,))
            outline.draw(canvas)
            ys, xs = np.nonzero(canvas[0])
            alpha = (canvas[0, ys, xs].astype(np.float32) / 255.0)[:, None]
            self._stamp = ((h, w), ys, xs, alpha)
        return self._stamp[1], self._stamp[2], self._stamp[3]


class RotatedKeypointsView:
    '''The cropped, rotated mask with the rotated keypoints about the crop's
    centre.'''

    def __init__(self, scale: float = 1.5, order: str = 'rgb'):
        self.scale = scale
        self.order = order

    def render(self, masks: np.ndarray, rot_keypoints: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        '''masks (N, h, w) crops; rot_keypoints (N, K, 2+) px about the
        crop's centre. ``out`` (N, h*scale, w*scale, 3) reuses a buffer.'''
        n, h, w = masks.shape
        sh, sw = int(h * self.scale), int(w * self.scale)
        if out is not None and out.shape == (n, sh, sw, 3):
            video = out
            video.fill(0)
        else:
            video = np.zeros((n, sh, sw, 3), dtype='uint8')
        origin = np.array([sw // 2, sh // 2], 'float64')
        masks = np.asarray(masks, 'uint8')
        if self.scale != 1.0:
            # nearest, by cv2's index rule (floor(dx * src / dst))
            iy = np.minimum((np.arange(sh) * (h / sh)).astype(np.intp), h - 1)
            ix = np.minimum((np.arange(sw) * (w / sw)).astype(np.intp), w - 1)
            masks = masks[:, iy[:, None], ix[None, :]]
        kpts_all = np.asarray(rot_keypoints, 'float64').copy()
        kpts_all[:, :, :2] = kpts_all[:, :, :2] * self.scale + origin
        draw.blend_windows(video, masks, None, _chan((0, 0, 255), self.order), 0.7)
        pts, fin, colors, skeleton = precompute_keypoint_draws(kpts_all, order=self.order)
        draws = DrawList()
        for i in range(n):
            draw_keypoints_fast(draws, i, pts[i], fin[i], colors, skeleton)
        draws.draw(video)
        return video


class CleanedFramesView:
    '''The cleaned crops under their masks in jet colours, resized.'''

    def __init__(self, vmin: float = 0, vmax: float = 100, scale: float = 1.5,
                 order: str = 'rgb'):
        self.vmin = vmin
        self.vmax = vmax
        self.scale = scale
        self.order = order

    def render(self, clean_frames: np.ndarray, masks: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        '''``out`` (N, h*scale, w*scale, 3) reuses a buffer.'''
        video = apply_colormap_jet(np.asarray(clean_frames) * (np.asarray(masks) > 0),
                                   self.vmin, self.vmax,
                                   out=out if self.scale == 1.0 else None, order=self.order)
        if self.scale != 1.0:
            n, h, w = video.shape[:3]
            sh, sw = int(h * self.scale), int(w * self.scale)
            scaled = out if out is not None and out.shape == (n, sh, sw, 3) and \
                out.flags.c_contiguous else None
            video = draw.resize_linear_block(video, (sw, sh), out=scaled)
        return video


def generate_raw_preview(input_file: str, output_file: Optional[str] = None,
                         min_height: float = 0, max_height: float = 100,
                         chunk_size: int = 1000, fps: int = 30,
                         bg_roi_depth_range: Tuple[float, float] = (650, 750),
                         device='cuda') -> str:
    '''A background-subtracted preview movie of a raw session (the ROI search
    and the dropout fill run on ``device``), ``preview.avi`` beside it by
    default.'''
    device = resolve_device(device)
    session = Session(input_file)
    session.find_roi(bg_roi_depth_range=bg_roi_depth_range, device=device)
    if output_file is None:
        output_file = os.path.join(session.dirname, 'preview.avi')
    writer = PreviewVideoWriter(output_file, fps=fps, vmin=min_height, vmax=max_height)

    def prep(frames):
        return prep_raw_frames(frames, bground_im=session.bground_im, roi=session.roi,
                               vmin=min_height, vmax=max_height, device=device).cpu().numpy()

    iterator = session.iterate(chunk_size=chunk_size)
    iterator.attach_filter(Stream.DEPTH, prep)
    try:
        for frame_idxs, chunk in iterator:
            writer.write_frames(np.asarray(frame_idxs), np.asarray(chunk))
    finally:
        writer.close()
    return output_file


class H5ResultPreviewVideoGenerator:
    '''Re-render a preview from a results file: the arena rebuilt from the
    cropped frames (``ops/warp.py:reverse_crop_and_rotate_frames``, on
    ``device``), and the crop with its rotated keypoints above the crop.'''

    def __init__(self, result_file: str, output_file: Optional[str] = None,
                 vmin: float = 0, vmax: float = 100, chunk_size: int = 1000,
                 fps: int = 30, device='cuda'):
        self.result_file = result_file
        self.output_file = output_file or os.path.splitext(result_file)[0] + '.preview.avi'
        self.vmin = vmin
        self.vmax = vmax
        self.chunk_size = chunk_size
        self.fps = fps
        self.device = resolve_device(device)

    def generate(self) -> str:
        '''Render the preview video; returns its path.'''
        with hdf5.File(self.result_file, 'r') as h5:
            nframes = h5['frames'].shape[0]
            roi = h5['metadata/extraction/roi'][()]
            ys, xs = np.nonzero(roi > 0)
            if len(ys):
                dest_h, dest_w = int(ys.max() - ys.min()), int(xs.max() - xs.min())
            else:
                dest_h, dest_w = roi.shape
            writer = PreviewVideoWriter(self.output_file, fps=self.fps, vmin=self.vmin,
                                        vmax=self.vmax)
            try:
                for start in range(0, nframes, self.chunk_size):
                    stop = min(start + self.chunk_size, nframes)
                    composite = self._render(h5, start, stop, (dest_h, dest_w))
                    writer.write_frames(np.arange(start, stop), composite)
            finally:
                writer.close()
        logging.info('Wrote %s', self.output_file)
        return self.output_file

    def _render(self, h5, start: int, stop: int, dest: Tuple[int, int]) -> np.ndarray:
        '''Frames [start, stop) as composites: the rebuilt arena, then the
        crop with its rotated keypoints over the bare crop.'''
        dest_h, dest_w = dest
        frames = h5['frames'][start:stop]
        centroid = np.stack([h5['scalars/centroid_x_px'][start:stop],
                             h5['scalars/centroid_y_px'][start:stop]], axis=1)
        angles = np.rad2deg(h5['scalars/angle'][start:stop])
        rot_kpts = np.stack(
            [np.stack([h5[f'keypoints/rotated/{n}_x_px'][start:stop],
                       h5[f'keypoints/rotated/{n}_y_px'][start:stop]], axis=1)
             for n in default_keypoint_names], axis=1)
        arena = reverse_crop_and_rotate_frames(
            torch.as_tensor(frames.astype('float32'), device=self.device),
            torch.as_tensor(centroid, device=self.device),
            torch.as_tensor(angles, device=self.device), (dest_w, dest_h)).cpu().numpy()
        arena_rgb = apply_colormap_jet(arena, self.vmin, self.vmax)
        crop_rgb = apply_colormap_jet(frames, self.vmin, self.vmax)
        n, ch, cw = frames.shape
        composite = np.zeros((n, max(dest_h, ch * 2), dest_w + cw, 3), dtype='uint8')
        composite[:, :dest_h, :dest_w] = arena_rgb
        panels = crop_rgb.copy()
        kpts = rot_kpts + np.array([cw / 2, ch / 2])
        pts, fin, colors, skeleton = precompute_keypoint_draws(kpts)
        draws = DrawList()
        for i in range(n):
            draw_keypoints_fast(draws, i, pts[i], fin[i], colors, skeleton)
        draws.draw(panels)
        composite[:, :ch, dest_w:dest_w + cw] = panels
        composite[:, ch:ch * 2, dest_w:dest_w + cw] = crop_rgb
        return composite
