'''Batched crop-and-rotate of frames around their centroids, on the device.

Port of ``moseq2_detectron_extract_tpu/ops/warp.py`` (lines 18-153):
``_cv2_rotation_matrix``, ``_invert_affine``, ``_bilinear_window_sample``,
``_inverse_map_grid``, ``crop_and_rotate_frames`` and its inverse
``reverse_crop_and_rotate_frames``, batched over frames in f32 with
explicit index arithmetic (``grid_sample``'s border and corner rules are
not these functions').

The reference crops the window before it rotates, so an output pixel whose
rotated source lies outside the crop window is zero even where the frame
has data: taps are masked to the window as well as to the frame.
'''
import numpy as np
import torch

_DEG2RAD = np.float32(np.pi / 180)


def _cv2_rotation_matrix(center, angle_deg: torch.Tensor):
    '''(N, 2, 3) forward affine of ``cv2.getRotationMatrix2D(center, angle,
    1)`` for (N,) f32 angles about one ``center`` (x, y).

    The cosine and sine of the f32 angle are taken in f64 and rounded once
    to f32, so that every device builds the same f32 matrix (f32 ``cos``
    differs by an ulp or two between CUDA and the CPU, which moves a
    source coordinate by up to 2e-5 px); the rest is f32.'''
    theta = (angle_deg * _DEG2RAD).double()
    alpha = torch.cos(theta).float()
    beta = torch.sin(theta).float()
    cx, cy = float(center[0]), float(center[1])
    return torch.stack([
        torch.stack([alpha, beta, (1.0 - alpha) * cx - beta * cy], dim=-1),
        torch.stack([-beta, alpha, beta * cx + (1.0 - alpha) * cy], dim=-1)], dim=1)


def _invert_affine(m: torch.Tensor) -> torch.Tensor:
    '''Closed-form inverse of (N, 2, 3) affines [[a, b, tx], [c, d, ty]].'''
    a, b, tx = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    c, d, ty = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    return torch.stack([
        torch.stack([ia, ib, -(ia * tx + ib * ty)], dim=-1),
        torch.stack([ic, id_, -(ic * tx + id_ * ty)], dim=-1)], dim=1)


def _inverse_map_grid(inv: torch.Tensor, out_h: int, out_w: int):
    '''Source coordinates (N, out_h, out_w) of each output pixel.'''
    ygrid = torch.arange(out_h, dtype=torch.float32, device=inv.device)[:, None] \
        .expand(out_h, out_w)
    xgrid = torch.arange(out_w, dtype=torch.float32, device=inv.device)[None, :] \
        .expand(out_h, out_w)
    m = inv[:, :, :, None, None]
    src_x = m[:, 0, 0] * xgrid + m[:, 0, 1] * ygrid + m[:, 0, 2]
    src_y = m[:, 1, 0] * xgrid + m[:, 1, 1] * ygrid + m[:, 1, 2]
    return src_x, src_y


def _bilinear_window_sample(img: torch.Tensor, wxs, wys, off_x, off_y,
                            win_w: int, win_h: int) -> torch.Tensor:
    '''Bilinear samples of (N, H, W) ``img`` at window coordinates (N, h, w);
    tap (wx, wy) reads ``img[wy + off_y, wx + off_x]`` (offsets (N,)) and is
    zero outside the window [0, win_w) x [0, win_h) or outside the image.'''
    n, h, w = img.shape
    x0 = torch.floor(wxs)
    y0 = torch.floor(wys)
    fx = wxs - x0
    fy = wys - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    offx = torch.round(off_x).to(torch.int64)[:, None, None]
    offy = torch.round(off_y).to(torch.int64)[:, None, None]
    flat = img.reshape(n, h * w)

    def tap(wyi, wxi):
        in_window = (wxi >= 0) & (wxi < win_w) & (wyi >= 0) & (wyi < win_h)
        xi = wxi + offx
        yi = wyi + offy
        in_img = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        v = torch.gather(flat, 1, idx.reshape(n, -1)).reshape(idx.shape)
        return torch.where(in_window & in_img, v.float(), torch.zeros((), device=img.device))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def crop_and_rotate_frames(frames: torch.Tensor, centers, angles_deg,
                           crop_size=(80, 80)) -> torch.Tensor:
    '''Crop ``crop_size`` (width, height) windows of (N, H, W) ``frames`` at
    ``centers`` (N, 2 [x, y]) and rotate them by ``angles_deg`` (N,).

    The window origin is ``trunc(center - crop // 2)``; the rotation is
    ``cv2.getRotationMatrix2D`` about the crop's centre, bilinear, with
    zero taps outside the window and outside the frame. A NaN angle, a NaN
    centre or a negative centre gives a zero frame. Returns f32 (N,
    crop_h, crop_w) on the frames' device.
    '''
    crop_w, crop_h = int(crop_size[0]), int(crop_size[1])
    dev = frames.device
    centers = torch.as_tensor(centers, device=dev).to(torch.float32)
    angles = torch.as_tensor(angles_deg, device=dev).to(torch.float32)
    invalid = torch.isnan(angles) | torch.isnan(centers).any(-1) | (centers < 0).any(-1)
    zero = torch.zeros((), device=dev)
    safe_center = torch.where(torch.isnan(centers), zero, centers)
    safe_angle = torch.where(torch.isnan(angles), zero, angles)

    # the window origin in frame coordinates, truncated like int()
    ox = torch.trunc(safe_center[:, 0] - crop_w // 2)
    oy = torch.trunc(safe_center[:, 1] - crop_h // 2)
    inv = _invert_affine(_cv2_rotation_matrix((crop_w // 2, crop_h // 2), safe_angle))
    wx, wy = _inverse_map_grid(inv, crop_h, crop_w)
    out = _bilinear_window_sample(frames, wx, wy, ox, oy, crop_w, crop_h)
    return torch.where(invalid[:, None, None], zero, out)


def reverse_crop_and_rotate_frames(frames: torch.Tensor, centers, angles_deg,
                                   dest_size=(512, 424)) -> torch.Tensor:
    '''The inverse of ``crop_and_rotate_frames``: (N, crop_h, crop_w) crops
    put back into a ``dest_size`` (width, height) canvas at ``centers`` (N,
    2 [x, y]), unrotated by ``angles_deg`` (N,).

    Two bilinear warps as the reference's: rotate by -angle about the crop's
    centre into the canvas (zero outside the crop), then translate by
    (centre - crop centre) (zero outside the canvas). A NaN angle or centre
    gives a zero frame. Returns f32 (N, dest_h, dest_w) on the frames'
    device.'''
    dest_w, dest_h = int(dest_size[0]), int(dest_size[1])
    n, crop_h, crop_w = frames.shape
    dev = frames.device
    centers = torch.as_tensor(centers, device=dev).to(torch.float32)
    angles = torch.as_tensor(angles_deg, device=dev).to(torch.float32)
    invalid = torch.isnan(angles) | torch.isnan(centers).any(-1)
    zero = torch.zeros((), device=dev)
    safe_center = torch.where(torch.isnan(centers), zero, centers)
    safe_angle = torch.where(torch.isnan(angles), zero, angles)

    src_center = (crop_w // 2, crop_h // 2)
    inv = _invert_affine(_cv2_rotation_matrix(src_center, -safe_angle))
    wx, wy = _inverse_map_grid(inv, dest_h, dest_w)
    no_offset = torch.zeros(n, device=dev)
    stage1 = _bilinear_window_sample(frames.to(torch.float32), wx, wy, no_offset, no_offset,
                                     crop_w, crop_h)
    tx = (safe_center[:, 0] - src_center[0])[:, None, None]
    ty = (safe_center[:, 1] - src_center[1])[:, None, None]
    ygrid = torch.arange(dest_h, dtype=torch.float32, device=dev)[None, :, None]
    xgrid = torch.arange(dest_w, dtype=torch.float32, device=dev)[None, None, :]
    out = _bilinear_window_sample(stage1, (xgrid - tx).expand(n, dest_h, dest_w),
                                  (ygrid - ty).expand(n, dest_h, dest_w), no_offset,
                                  no_offset, dest_w, dest_h)
    return torch.where(invalid[:, None, None], zero, out)
