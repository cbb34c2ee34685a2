'''The JAX package's random draws, for the port's compute functions.

The port separates drawing from computing: its losses and augmentations
take their random values as arguments. These helpers make the values the
JAX functions draw for themselves, with the same tree of key splits
(``models/rcnn.py:256-258, 285-286``, ``models/matcher.py:60``,
``models/augment.py:123-128, 247-248``), so that the port computes on the
same numbers.
'''
import numpy as np
import torch

import jax


def subsample_uniforms(key, n: int):
    '''``subsample_labels``' two priority vectors for one image.'''
    key_pos, key_neg = jax.random.split(key)
    return (np.asarray(jax.random.uniform(key_pos, (n,))),
            np.asarray(jax.random.uniform(key_neg, (n,))))


def _per_image(keys, n: int):
    pairs = [subsample_uniforms(k, n) for k in keys]
    return tuple(torch.from_numpy(np.stack([p[i] for p in pairs])) for i in range(2))


def loss_draws(rng, batch: int, n_anchors: int, n_rois: int):
    '''The draws of ``MaskKeypointRCNN.losses(..., rng)``: the RPN's and the
    ROI sampling's uniform priorities, as the port's ``draws`` dict.'''
    rng, rpn_rng = jax.random.split(rng)
    rpn_keys = jax.random.split(rpn_rng, batch)
    rng, roi_rng = jax.random.split(rng)
    roi_keys = jax.random.split(roi_rng, batch)
    return {'rpn': _per_image(rpn_keys, n_anchors), 'roi': _per_image(roi_keys, n_rois)}


def _uniform(key, lo, hi):
    return float(jax.random.uniform(key, (), minval=lo, maxval=hi))


def _normals(key, shape):
    k1, k2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(k1, shape)),
                     np.asarray(jax.random.normal(k2, shape))])


def grf_draws(key, shape, std_range, power_range, imax_range):
    '''``random_field_noise`` / ``doughnut_grf_noise``-style draws without
    the thickness (``augment.py:100-105``).'''
    k_apply, k_std, k_pow, k_int, k_field = jax.random.split(key, 5)
    return {'apply_u': float(jax.random.uniform(k_apply)),
            'std': _uniform(k_std, *std_range), 'power': _uniform(k_pow, *power_range),
            'imax': _uniform(k_int, *imax_range), 'field': _normals(k_field, shape)}


def doughnut_draws(key, shape):
    k_apply, k_th, k_std, k_pow, k_int, k_field = jax.random.split(key, 6)
    return {'apply_u': float(jax.random.uniform(k_apply)),
            'thickness': _uniform(k_th, 0.0, 30.0), 'std': _uniform(k_std, 75.0, 100.0),
            'power': _uniform(k_pow, 1.5, 2.5), 'imax': _uniform(k_int, 30.0, 100.0),
            'field': _normals(k_field, shape)}


def particle_draws(key, shape, max_particles: int = 4):
    '''``particle_noise``'s draws (``augment.py:119-144``): each particle
    keyed by ``fold_in(k_apply, i + 1)``.'''
    h, w = shape
    k_apply, k_n, *_ = jax.random.split(key, 2 + max_particles)
    out = {'apply_u': float(jax.random.uniform(k_apply)),
           'n_particles': int(jax.random.randint(k_n, (), 1, max_particles + 1)),
           'radius': [], 'cx': [], 'cy': [], 'std': [], 'power': [], 'imax': [],
           'field': [], 'deform': []}
    for i in range(max_particles):
        pk = jax.random.fold_in(k_apply, i + 1)
        k_r, k_c1, k_c2, k_std, k_pow, k_int, k_field, k_def = jax.random.split(pk, 8)
        out['radius'].append(_uniform(k_r, 3.0, 20.0))
        out['cx'].append(_uniform(k_c1, 0.0, w))
        out['cy'].append(_uniform(k_c2, 0.0, h))
        out['std'].append(_uniform(k_std, 75.0, 100.0))
        out['power'].append(_uniform(k_pow, 2.5, 4.0))
        out['imax'].append(_uniform(k_int, 30.0, 250.0))
        out['field'].append(_normals(k_field, shape))
        out['deform'].append(np.asarray(jax.random.normal(k_def, (2, 8, 8))))
    return out


def gauss_draws(key, shape):
    k_apply, k_var, k_noise = jax.random.split(key, 3)
    return {'apply_u': float(jax.random.uniform(k_apply)),
            'var': _uniform(k_var, 10.0, 50.0),
            'noise': np.asarray(jax.random.normal(k_noise, shape))}


def sample_draws(key, s: int):
    '''``augment_sample``'s draws for one (s, s) image, as plain values.'''
    (k_rot, k_scale, k_bright, k_contrast, k_gauss, k_grf, k_part,
     k_donut) = jax.random.split(key, 8)
    return {'angle': _uniform(k_rot, 0.0, 359.0), 'scale': _uniform(k_scale, 0.75, 1.2),
            'brightness': _uniform(k_bright, 0.9, 1.1),
            'contrast': _uniform(k_contrast, 0.9, 1.1),
            'gauss': gauss_draws(k_gauss, (s, s)),
            'donut': doughnut_draws(k_donut, (s, s)),
            'particle': particle_draws(k_part, (s, s)),
            'grf': grf_draws(k_grf, (s, s), (5.0, 100.0), (1.0, 4.0), (5.0, 65.0))}


def stack_draws(per_image):
    '''Per-image draw dicts -> the port's batched draws (tensors with a
    leading batch axis; particle fields (B, P, ...)).'''
    def stack(values):
        first = values[0]
        if isinstance(first, dict):
            return {k: stack([v[k] for v in values]) for k in first}
        arr = np.stack([np.asarray(v) for v in values])
        if arr.dtype.kind == 'f':
            return torch.from_numpy(arr.astype(np.float32))
        return torch.from_numpy(arr.astype(np.int64))
    return stack(per_image)


def augment_batch_draws(key, batch: int, s: int):
    '''``augment_batch``'s draws: one ``augment_sample`` key per image.'''
    return stack_draws([sample_draws(k, s) for k in jax.random.split(key, batch)])
