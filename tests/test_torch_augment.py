'''Port vs JAX package: the training augmentations, on the CPU, with the
JAX package's own draws (``tests/jax_draws.py``) handed to the port.

Tolerances, in grey levels of 0-255 images: each noise transform and the
whole ``augment_batch`` to 1e-4 relative to the image's largest value (in
the whole batch at most 2 pixels beyond it: see the test)
(the FFT of a random field runs in another library, pocketfft or MKL
against XLA's, and its f32 rounding reaches the field's rescale to up to
250 grey levels); the cubic grid weights 1e-6; the affine samples 1e-4;
masks, boxes, validity and keypoint visibility equal. ``augment_sample``
equals ``augment_batch`` on a batch of one with the same draw exactly, and
meets the JAX ``augment_sample`` on its own draws at the batch's tolerances.
'''
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moseq2_detectron_extract_tpu.models import augment as jaug
from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
from moseq2_detectron_extract_tpu_torch.models import augment

from tests.jax_draws import (augment_batch_draws, doughnut_draws, gauss_draws, grf_draws,
                             particle_draws, sample_draws, stack_draws)

S = 48


def _rel_close(ours, ref, rel=1e-4):
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1.0)
    err = np.abs(np.asarray(ours, np.float64) - ref).max()
    assert err <= rel * scale, (err, scale)


def _image(seed, b=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 80, (b, S, S)).astype('float32')


def _animal(seed, b=3):
    m = np.zeros((b, S, S), 'float32')
    m[:, 10:30, 14:36] = 1.0
    return m


def _keys(seed, b=3):
    return jax.random.split(jax.random.PRNGKey(seed), b)


def test_gauss_noise_matches_jax():
    img, keys = _image(0), _keys(0)
    draws = stack_draws([gauss_draws(k, (S, S)) for k in keys])
    ours = augment.gauss_noise(draws, torch.from_numpy(img))
    for i, k in enumerate(keys):
        _rel_close(ours[i].numpy(), jaug.gauss_noise(k, jnp.asarray(img[i])))
    assert (draws['apply_u'] < 0.5).any()


@pytest.mark.parametrize('kind', ['grf', 'donut'])
def test_field_noises_match_jax(kind):
    img, animal, keys = _image(1), _animal(1), _keys(1, 6)
    img, animal = np.concatenate([img, img]), np.concatenate([animal, animal])
    if kind == 'grf':
        draws = stack_draws([grf_draws(k, (S, S), (5.0, 100.0), (1.0, 4.0), (5.0, 65.0))
                             for k in keys])
        ours = augment.random_field_noise(draws, torch.from_numpy(img),
                                          torch.from_numpy(animal))
        ref_fn = jaug.random_field_noise
    else:
        draws = stack_draws([doughnut_draws(k, (S, S)) for k in keys])
        ours = augment.doughnut_grf_noise(draws, torch.from_numpy(img),
                                          torch.from_numpy(animal))
        ref_fn = jaug.doughnut_grf_noise
    ref_fn = jax.jit(ref_fn)
    for i, k in enumerate(keys):
        _rel_close(ours[i].numpy(), ref_fn(k, jnp.asarray(img[i]), jnp.asarray(animal[i])))
    applied = draws['apply_u'] < 0.5
    assert applied.any() and not applied.all()


def test_particle_noise_matches_jax():
    img, keys = _image(2, 6), _keys(2, 6)
    draws = stack_draws([particle_draws(k, (S, S)) for k in keys])
    ours = augment.particle_noise(draws, torch.from_numpy(img))
    ref_fn = jax.jit(jaug.particle_noise)
    for i, k in enumerate(keys):
        _rel_close(ours[i].numpy(), ref_fn(k, jnp.asarray(img[i])))
    assert len(set(draws['n_particles'].tolist())) > 1


@pytest.mark.parametrize('h,w', [(48, 48), (160, 160), (37, 64)])
def test_cubic_grid_matches_jax_image_resize(h, w):
    grid = np.random.default_rng(h).normal(0, 3, (2, 8, 8)).astype('float32')
    ref = jax.image.resize(jnp.asarray(grid), (2, h, w), method='bicubic')
    wy = augment.keys_cubic_weights(8, h, 'cpu')
    wx = augment.keys_cubic_weights(8, w, 'cpu')
    ours = torch.einsum('cij,ih,jw->chw', torch.from_numpy(grid), wy, wx)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)
    # the border taps are renormalised, not replicated: the columns sum to 1
    np.testing.assert_allclose(wy.sum(0).numpy(), 1.0, atol=1e-6)


def test_elastic_deform_matches_jax():
    img = _image(3)
    keys = _keys(3)
    sigma = np.array([1.5, 4.0, 9.0], 'float32')
    normals = np.stack([np.asarray(jax.random.normal(k, (2, 8, 8))) for k in keys])
    ours = augment.elastic_deform(torch.from_numpy(normals), torch.from_numpy(img),
                                  torch.from_numpy(sigma))
    for i, k in enumerate(keys):
        _rel_close(ours[i].numpy(), jaug.elastic_deform(k, jnp.asarray(img[i]), sigma[i]))


@pytest.mark.parametrize('nearest', [False, True])
def test_affine_sample_matches_jax(nearest):
    img = _image(4)
    angles = np.array([17.0, 123.5, 300.0], 'float32')
    scales = np.array([0.8, 1.0, 1.17], 'float32')
    ours_fwd = augment._rotation_scale_matrix((S / 2.0, S / 2.0), torch.from_numpy(angles),
                                              torch.from_numpy(scales))
    inv = augment._invert_affine(ours_fwd)
    ours = augment._affine_sample(torch.from_numpy(img), inv, order_nearest=nearest)
    for i in range(3):
        fwd = jaug._rotation_scale_matrix((S / 2.0, S / 2.0), jnp.asarray(angles[i]),
                                          jnp.asarray(scales[i]))
        jinv = jaug._invert_affine(fwd)
        np.testing.assert_allclose(inv[i].numpy(), np.asarray(jinv), rtol=1e-6, atol=1e-5)
        ref = jaug._affine_sample(jnp.asarray(img[i]), jinv, order_nearest=nearest)
        _rel_close(ours[i].numpy(), ref)


def _gt_batch(b, g=2, k=8, seed=5):
    rng = np.random.default_rng(seed)
    masks = np.zeros((b, g, S, S), bool)
    kpts = np.zeros((b, g, k, 3), 'float32')
    valid = np.zeros((b, g), bool)
    for i in range(b):
        x1, y1 = rng.integers(6, 20, 2)
        masks[i, 0, y1:y1 + 14, x1:x1 + 20] = True
        kpts[i, 0, :, 0] = np.linspace(x1, x1 + 20, k)
        kpts[i, 0, :, 1] = y1 + 7
        kpts[i, 0, :, 2] = 2.0
        kpts[i, 0, 0] = (0.5, 0.5, 2.0)                  # a corner point: may leave
        valid[i, 0] = True
    return masks, kpts, valid


def test_augment_batch_matches_jax():
    b = 4
    cfg = JaxModelConfig(image_size=S, max_gt_instances=2)
    images = _image(6, b)
    masks, kpts, valid = _gt_batch(b)
    key = jax.random.PRNGKey(8)
    ref_x, ref_gt = jax.jit(lambda k: jaug.augment_batch(k, images, masks, kpts, valid, cfg))(
        key)
    draws = augment_batch_draws(key, b, S)
    x, gt = augment.augment_batch(draws, torch.from_numpy(images), torch.from_numpy(masks),
                                  torch.from_numpy(kpts), torch.from_numpy(valid), cfg)
    assert x.shape == (b, 3, S, S)
    ref_x = np.asarray(ref_x)
    err = np.abs(x.permute(0, 2, 3, 1).numpy() - ref_x)[..., 0]
    off = err > 1e-4 * np.abs(ref_x).max()
    # The elastic sampling clamps its taps into the image: a sample that a
    # one-ulp displacement difference moves across the image's edge takes
    # another pixel (the cubic grid's f32 sums run in another order in XLA,
    # and cannot be matched bit for bit). Measured: 1 such pixel in this batch.
    assert off.sum() <= 2, (int(off.sum()), float(err.max()))
    np.testing.assert_array_equal(gt['masks'].numpy(), np.asarray(ref_gt['masks']))
    np.testing.assert_array_equal(gt['boxes'].numpy(), np.asarray(ref_gt['boxes']))
    np.testing.assert_array_equal(gt['valid'].numpy(), np.asarray(ref_gt['valid']))
    np.testing.assert_array_equal(gt['keypoints'][..., 2].numpy(),
                                  np.asarray(ref_gt['keypoints'][..., 2]))
    np.testing.assert_allclose(gt['keypoints'][..., :2].numpy(),
                               np.asarray(ref_gt['keypoints'][..., :2]), atol=1e-4)
    assert gt['valid'][:, 0].all() and not gt['valid'][:, 1].any()


def test_draw_augment_ranges():
    g = torch.Generator().manual_seed(0)
    d = augment.draw_augment(g, 64, 32, 'cpu')
    ranges = {('angle',): (0, 359), ('scale',): (0.75, 1.2), ('brightness',): (0.9, 1.1),
              ('contrast',): (0.9, 1.1), ('gauss', 'var'): (10, 50),
              ('donut', 'thickness'): (0, 30), ('donut', 'std'): (75, 100),
              ('donut', 'power'): (1.5, 2.5), ('donut', 'imax'): (30, 100),
              ('particle', 'radius'): (3, 20), ('particle', 'cx'): (0, 32),
              ('particle', 'std'): (75, 100), ('particle', 'power'): (2.5, 4),
              ('particle', 'imax'): (30, 250), ('grf', 'std'): (5, 100),
              ('grf', 'power'): (1, 4), ('grf', 'imax'): (5, 65)}
    for path, (lo, hi) in ranges.items():
        v = d[path[0]] if len(path) == 1 else d[path[0]][path[1]]
        assert float(v.min()) >= lo and float(v.max()) <= hi, path
        assert float(v.max()) - float(v.min()) > 0.5 * (hi - lo), path
    n = d['particle']['n_particles']
    assert set(n.tolist()) == {1, 2, 3, 4}
    assert d['particle']['field'].shape == (64, 4, 2, 32, 32)
    assert d['particle']['deform'].shape == (64, 4, 2, 8, 8)
    assert d['gauss']['noise'].shape == (64, 32, 32)
    # the same seed draws the same values
    again = augment.draw_augment(torch.Generator().manual_seed(0), 64, 32, 'cpu')
    assert torch.equal(again['grf']['field'], d['grf']['field'])


@pytest.mark.parametrize('seed', [0, 1])
def test_augment_sample_matches_batch_of_one_and_jax(seed):
    cfg = JaxModelConfig(image_size=S, max_gt_instances=2)
    image = _image(20 + seed, 1)[0]
    masks, kpts, valid = (a[0] for a in _gt_batch(1, seed=21 + seed))
    args = [torch.from_numpy(a) for a in (image, masks, kpts, valid)]

    draws = augment.draw_augment(torch.Generator().manual_seed(seed), 1, S, 'cpu')
    one = augment.augment_sample(augment.take_draw(draws, 0), *args, cfg)
    x, gt = augment.augment_batch(draws, *(a[None] for a in args), cfg)
    mean = torch.tensor(cfg.pixel_mean)[:, None, None]
    std = torch.tensor(cfg.pixel_std)[:, None, None]
    assert torch.equal((one['image'][None] - mean) / std, x[0])
    for key in ('boxes', 'valid', 'masks', 'keypoints'):
        assert torch.equal(one[key], gt[key][0]), key

    key = jax.random.PRNGKey(30 + seed)
    ref = jax.jit(lambda *a: jaug.augment_sample(*a, cfg))(key, image, masks, kpts, valid)
    ours = augment.augment_sample(augment.take_draw(stack_draws([sample_draws(key, S)]), 0),
                                  *args, cfg)
    ref_image = np.asarray(ref['image'])
    err = np.abs(ours['image'].numpy() - ref_image)
    assert (err > 1e-4 * np.abs(ref_image).max()).sum() <= 2, float(err.max())
    for name in ('masks', 'boxes', 'valid'):
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(ref[name]), err_msg=name)
    np.testing.assert_array_equal(ours['keypoints'][..., 2].numpy(),
                                  np.asarray(ref['keypoints'][..., 2]))
    np.testing.assert_allclose(ours['keypoints'][..., :2].numpy(),
                               np.asarray(ref['keypoints'][..., :2]), atol=1e-4)
