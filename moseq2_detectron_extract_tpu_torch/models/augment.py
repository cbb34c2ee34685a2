'''Training augmentations on the device, batched over the images.

Port of ``moseq2_detectron_extract_tpu/models/augment.py``: rotation and
scale (one inverse-affine sample), brightness and contrast, Gaussian
noise, and the depth-noise family (Gaussian random fields by FFT
synthesis: the arena-wall doughnut, 1-4 elastic-deformed particles, and
background field noise), then boxes recomputed from the augmented masks.

Drawing is separate from computing: :func:`draw_augment` draws every random
value of a batch from a ``torch.Generator`` into a dict, and
:func:`augment_batch` computes from that dict alone, so the tests can hand
it the JAX package's own draws. :func:`augment_sample` augments one sample
from one sample's draws (:func:`take_draw`). Two details follow ``jax.image.resize`` and
``jnp.round`` exactly:

* the elastic grid is upsampled with Keys' cubic (a = -0.5), the weights
  renormalised over the taps inside the grid (:func:`keys_cubic_weights`);
  ``F.interpolate(mode='bicubic')`` has a = -0.75 and replicates the
  border, so it is not used;
* nearest sampling rounds halves to even (``torch.round``), as
  ``jnp.round`` does.
'''
import math
from typing import Dict, Tuple

import torch

from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig

_EPS = 2.220446049250313e-16
MAX_PARTICLES = 4
ELASTIC_POINTS = 8


# -- gaussian random fields -------------------------------------------------------

def _fftfreq(n: int, device) -> torch.Tensor:
    '''``jnp.fft.fftfreq(n)`` in f32: the wrapped integers divided by n.'''
    k = torch.arange(n, dtype=torch.float32, device=device)
    k = torch.where(k < (n + 1) // 2, k, k - n)
    return k / torch.tensor(float(n), dtype=torch.float32, device=device)


def grf_field(normals: torch.Tensor, std: torch.Tensor, power: torch.Tensor) -> torch.Tensor:
    '''Gaussian random fields with power spectrum k^-power: ``normals``
    (..., 2, H, W) the real and imaginary white noise, ``std`` and ``power``
    (...) -> (..., H, W).'''
    h, w = normals.shape[-2:]
    dev = normals.device
    ky = _fftfreq(h, dev)[:, None]
    kx = _fftfreq(w, dev)[None, :]
    knorm = torch.sqrt(ky * ky + kx * kx)
    amplitude = torch.pow(knorm + _EPS, (-power / 2.0)[..., None, None])
    amplitude = torch.where(knorm != 0, amplitude, torch.zeros_like(amplitude))   # [0, 0]
    std = std[..., None, None]
    spectrum = torch.complex(normals[..., 0, :, :] * std * amplitude,
                             normals[..., 1, :, :] * std * amplitude)
    return torch.fft.ifft2(spectrum).real * (h * w) ** 0.5


def rescale_intensity(field: torch.Tensor, vmax: torch.Tensor) -> torch.Tensor:
    '''Stretch each (H, W) field linearly to [0, vmax].'''
    dmin = torch.amin(field, dim=(-2, -1), keepdim=True)
    dmax = torch.amax(field, dim=(-2, -1), keepdim=True)
    return (field - dmin) * (vmax[..., None, None] /
                             torch.clamp(dmax - dmin, min=1e-9))


def _grid(h: int, w: int, device):
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return yy, xx


def _circular_mask(shape, cx, cy, radius):
    yy, xx = _grid(*shape, cx.device)
    dx = xx - cx[..., None, None]
    dy = yy - cy[..., None, None]
    return torch.sqrt(dx * dx + dy * dy) <= radius[..., None, None]


def _doughnut_mask(shape, thickness):
    h, w = shape
    cx, cy = w / 2.0, h / 2.0
    radius = min(cx, cy)
    yy, xx = _grid(h, w, thickness.device)
    dist = torch.sqrt((xx - cx) * (xx - cx) + (yy - cy) * (yy - cy))
    return (dist <= radius) & (dist >= radius - thickness[..., None, None])


def keys_cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    '''(n_in, n_out) weights of ``jax.image.resize(..., 'bicubic')`` along
    one axis: Keys' cubic (a = -0.5) at half-pixel centres, each column
    renormalised over the taps inside the input, zero where the sample
    falls outside it.'''
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32, device=device)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                                 device=device)[:, None])
    inner = ((1.5 * x - 2.5) * x) * x + 1.0
    outer = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    weights = torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, outer, inner))
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * 1.1920928955078125e-07,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _bilinear_clamped(image: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor):
    '''Sample (N, H, W) images at (N, H, W) coordinates, taps clamped into
    the image (``elastic_deform``'s sampling).'''
    n, h, w = image.shape
    x0 = torch.floor(xx)
    y0 = torch.floor(yy)
    fx = xx - x0
    fy = yy - y0
    x0i = torch.clamp(x0.long(), 0, w - 1)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = image.reshape(n, h * w)

    def tap(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi).reshape(n, -1)).reshape(n, h, w)

    return (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x1i) * fx * (1 - fy)
            + tap(y1i, x0i) * (1 - fx) * fy + tap(y1i, x1i) * fx * fy)


def elastic_deform(normals: torch.Tensor, image: torch.Tensor, sigma: torch.Tensor):
    '''Random-grid elastic deformation: ``normals`` (..., 2, p, p) the
    control grid's displacements over ``sigma`` (...), cubic-upsampled to
    the (..., H, W) image, which is resampled bilinearly.'''
    lead = image.shape[:-2]
    h, w = image.shape[-2:]
    p = normals.shape[-1]
    disp = normals * sigma[..., None, None, None]
    wy = keys_cubic_weights(p, h, image.device)
    wx = keys_cubic_weights(p, w, image.device)
    full = torch.einsum('...cij,ih,jw->...chw', disp, wy, wx)
    yy, xx = _grid(h, w, image.device)
    out = _bilinear_clamped(image.reshape(-1, h, w), (yy + full[..., 0, :, :]).reshape(-1, h, w),
                            (xx + full[..., 1, :, :]).reshape(-1, h, w))
    return out.reshape(*lead, h, w)


# -- noise transforms (each applied with probability p) ------------------------------

def _apply(draw, p: float, image, noisy):
    return torch.where((draw['apply_u'] < p)[:, None, None], noisy, image)


def random_field_noise(draw: Dict, image, animal_mask, p: float = 0.5):
    '''GRF noise added to the background.'''
    field = grf_field(draw['field'], draw['std'], draw['power'])
    field = field * (1.0 - animal_mask)
    field = rescale_intensity(torch.abs(field), draw['imax'])
    return _apply(draw, p, image, image + field)


def particle_noise(draw: Dict, image, p: float = 0.5):
    '''1-4 elastic-deformed GRF particles added to the image (not masked
    off the animal); particle i counts when i < ``n_particles``.'''
    shape = image.shape[-2:]
    field = grf_field(draw['field'], draw['std'], draw['power'])          # (B, P, H, W)
    field = torch.where(_circular_mask(shape, draw['cx'], draw['cy'], draw['radius']),
                        field, torch.zeros_like(field))
    field = elastic_deform(draw['deform'], field, draw['radius'] / 2.0)
    field = rescale_intensity(torch.abs(field), draw['imax'])
    n_particles = draw['n_particles'][:, None, None]
    acc = torch.zeros_like(image)
    for i in range(field.shape[1]):
        acc = acc + torch.where(i < n_particles, field[:, i], torch.zeros_like(image))
    return _apply(draw, p, image, image + acc)


def doughnut_grf_noise(draw: Dict, image, animal_mask, p: float = 0.5):
    '''Arena-wall ring noise, masked off the animal.'''
    field = grf_field(draw['field'], draw['std'], draw['power'])
    field = torch.where(_doughnut_mask(image.shape[-2:], draw['thickness']), field,
                        torch.zeros_like(field))
    field = rescale_intensity(torch.abs(field), draw['imax'])
    field = field * (1.0 - animal_mask)
    return _apply(draw, p, image, image + field)


def gauss_noise(draw: Dict, image, p: float = 0.5):
    '''Additive Gaussian noise of variance ``var``.'''
    noise = draw['noise'] * torch.sqrt(draw['var'])[:, None, None]
    return _apply(draw, p, image, image + noise)


def max_blend(image, src_image):
    '''Per-pixel max blend (MaxBlendTransform).'''
    return torch.where(image > src_image, image, src_image)


def threshold_blend(image, src_image, threshold):
    '''``image`` where it exceeds ``threshold``, else ``src_image``.'''
    return torch.where(image > threshold, image, src_image)


# -- geometry ----------------------------------------------------------------------

def _affine_sample(image: torch.Tensor, matrix_inv: torch.Tensor, order_nearest=False):
    '''Sample (B, ..., H, W) images through (B, 3, 3) inverse affine maps,
    zero outside.'''
    b, h, w = image.shape[0], image.shape[-2], image.shape[-1]
    lead = image.shape[1:-2]
    yy, xx = _grid(h, w, image.device)
    m = matrix_inv.reshape(b, *([1] * len(lead)), 3, 3, 1, 1)
    sx = m[..., 0, 0, :, :] * xx + m[..., 0, 1, :, :] * yy + m[..., 0, 2, :, :]
    sy = m[..., 1, 0, :, :] * xx + m[..., 1, 1, :, :] * yy + m[..., 1, 2, :, :]
    flat = image.reshape(*image.shape[:-2], h * w)

    def tap(yi, xi, cast):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        idx = idx.expand(*image.shape[:-2], h, w).reshape(*image.shape[:-2], h * w)
        v = torch.gather(flat, -1, idx).reshape(image.shape)
        v = v.to(torch.float32) if cast else v
        return torch.where(inb, v, torch.zeros_like(v))

    if order_nearest:
        return tap(torch.round(sy).long(), torch.round(sx).long(), False)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.long()
    y0i = y0.long()
    return (tap(y0i, x0i, True) * (1 - fx) * (1 - fy) + tap(y0i, x0i + 1, True) * fx * (1 - fy)
            + tap(y0i + 1, x0i, True) * (1 - fx) * fy
            + tap(y0i + 1, x0i + 1, True) * fx * fy)


def _rotation_scale_matrix(center: Tuple[float, float], angle_deg, scale):
    '''(B, 3, 3) rotation by ``angle_deg`` and scale about ``center``.'''
    theta = angle_deg * torch.tensor(math.pi / 180, dtype=torch.float32)
    cos = torch.cos(theta) * scale
    sin = torch.sin(theta) * scale
    cx, cy = center
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([torch.stack([cos, -sin, cx - cos * cx + sin * cy], -1),
                        torch.stack([sin, cos, cy - sin * cx - cos * cy], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _invert_affine(m):
    a, b, tx = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    c, d, ty = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([ia, ib, -(ia * tx + ib * ty)], -1),
                        torch.stack([ic, id_, -(ic * tx + id_ * ty)], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def augment_images(draws: Dict, images, masks, keypoints, gt_valid) -> Dict[str, torch.Tensor]:
    '''The whole augmentation of a batch: images (B, S, S) f32, masks
    (B, G, S, S) bool, keypoints (B, G, K, 3), gt_valid (B, G) -> augmented
    image, masks, keypoints, and the boxes and validity recomputed from the
    masks (``augment_sample``, batched).'''
    s = images.shape[-1]
    fwd = _rotation_scale_matrix((s / 2.0, s / 2.0), draws['angle'], draws['scale'])
    inv = _invert_affine(fwd)
    image = _affine_sample(images, inv)
    masks = _affine_sample(masks.to(torch.float32), inv) > 0.5

    f = fwd[:, None, None]
    x, y = keypoints[..., 0], keypoints[..., 1]
    new_x = f[..., 0, 0] * x + f[..., 0, 1] * y + f[..., 0, 2]
    new_y = f[..., 1, 0] * x + f[..., 1, 1] * y + f[..., 1, 2]
    inside = (new_x >= 0) & (new_x < s) & (new_y >= 0) & (new_y < s)
    new_v = torch.where(inside, keypoints[..., 2], torch.zeros_like(keypoints[..., 2]))
    keypoints = torch.stack([new_x, new_y, new_v], dim=-1)

    mean = torch.mean(image, dim=(-2, -1), keepdim=True)
    image = (image - mean) * draws['contrast'][:, None, None] + mean
    image = image * draws['brightness'][:, None, None]

    animal = torch.any(masks & gt_valid[:, :, None, None], dim=1).to(torch.float32)
    image = gauss_noise(draws['gauss'], image)
    image = doughnut_grf_noise(draws['donut'], image, animal)
    image = particle_noise(draws['particle'], image)
    image = random_field_noise(draws['grf'], image, animal)
    image = torch.clamp(image, 0.0, 255.0)

    yy, xx = _grid(s, s, images.device)
    inf = torch.tensor(torch.inf, device=images.device)
    x1 = torch.amin(torch.where(masks, xx, inf), dim=(-2, -1))
    y1 = torch.amin(torch.where(masks, yy, inf), dim=(-2, -1))
    x2 = torch.amax(torch.where(masks, xx, -inf), dim=(-2, -1)) + 1
    y2 = torch.amax(torch.where(masks, yy, -inf), dim=(-2, -1)) + 1
    any_mask = torch.any(masks, dim=(-2, -1))
    boxes = torch.where(any_mask[..., None], torch.stack([x1, y1, x2, y2], -1),
                        torch.zeros(4, device=images.device))
    return {'image': image, 'masks': masks, 'keypoints': keypoints, 'boxes': boxes,
            'valid': gt_valid & any_mask}


def _map_draws(fn, draws: Dict) -> Dict:
    return {k: _map_draws(fn, v) if isinstance(v, dict) else fn(v) for k, v in draws.items()}


def take_draw(draws: Dict, index: int) -> Dict:
    '''Sample ``index``'s draws from a batch's (:func:`draw_augment`).'''
    return _map_draws(lambda v: v[index], draws)


def augment_sample(draw: Dict, image, masks, keypoints, gt_valid,
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    '''The whole augmentation of one sample from its draws (a batch's
    :func:`take_draw`): image (S, S) f32, masks (G, S, S) bool, keypoints
    (G, K, 3 [x, y, v]), gt_valid (G,) -> augmented image, masks and
    keypoints, and the boxes and validity recomputed from the masks
    (:func:`augment_images` on a batch of one).'''
    del cfg
    out = augment_images(_map_draws(lambda v: v[None], draw), image[None], masks[None],
                         keypoints[None], gt_valid[None])
    return {k: v[0] for k, v in out.items()}


def augment_batch(draws: Dict, images, masks, keypoints, gt_valid, cfg: ModelConfig):
    ''':func:`augment_images`, then the normalized 3-channel images
    (B, 3, S, S) and the gt dict of ``MaskKeypointRCNN.losses``.'''
    out = augment_images(draws, images, masks, keypoints, gt_valid)
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=images.device)
    x = (out['image'][:, None] - mean[None, :, None, None]) / std[None, :, None, None]
    gt = {'boxes': out['boxes'], 'valid': out['valid'], 'masks': out['masks'],
          'keypoints': out['keypoints']}
    return x, gt


def draw_augment(generator: torch.Generator, batch: int, size: int, device,
                 max_particles: int = MAX_PARTICLES) -> Dict:
    '''Every random value of :func:`augment_batch` for ``batch`` (size,
    size) images, in the JAX package's ranges.'''
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((batch, *shape), generator=generator,
                                           device=device)

    def normals(*shape):
        return torch.randn((batch, *shape), generator=generator, device=device)

    s = size
    p = max_particles
    return {
        'angle': u(0.0, 359.0), 'scale': u(0.75, 1.2),
        'brightness': u(0.9, 1.1), 'contrast': u(0.9, 1.1),
        'gauss': {'apply_u': u(0.0, 1.0), 'var': u(10.0, 50.0), 'noise': normals(s, s)},
        'donut': {'apply_u': u(0.0, 1.0), 'thickness': u(0.0, 30.0), 'std': u(75.0, 100.0),
                  'power': u(1.5, 2.5), 'imax': u(30.0, 100.0), 'field': normals(2, s, s)},
        'particle': {'apply_u': u(0.0, 1.0),
                     'n_particles': torch.randint(1, p + 1, (batch,), generator=generator,
                                                  device=device),
                     'radius': u(3.0, 20.0, p), 'cx': u(0.0, float(s), p),
                     'cy': u(0.0, float(s), p), 'std': u(75.0, 100.0, p),
                     'power': u(2.5, 4.0, p), 'imax': u(30.0, 250.0, p),
                     'field': normals(p, 2, s, s),
                     'deform': normals(p, 2, ELASTIC_POINTS, ELASTIC_POINTS)},
        'grf': {'apply_u': u(0.0, 1.0), 'std': u(5.0, 100.0), 'power': u(1.0, 4.0),
                'imax': u(5.0, 65.0), 'field': normals(2, s, s)},
    }
