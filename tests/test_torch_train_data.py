'''Port vs JAX package (and cv2): the input side of training, on the CPU.

* PNG: the port's reader against ``cv2.imread(..., IMREAD_UNCHANGED)`` on
  files cv2 wrote (8-bit grey, RGB, RGBA and 16-bit grey, three
  compression levels) and on files with every row filter, equal; the
  port's writer read back by cv2, equal; an interlaced file raises.
* ``poly_to_mask`` against ``cv2.fillPoly`` on convex, concave and thin
  random polygons, self-crossing ones and ones that leave the image:
  equal; ``point_in_polygon`` against ``cv2.pointPolygonTest``: equal.
* ``load_sample`` against the JAX package's (cv2's INTER_LINEAR resize):
  the image to 1e-4 of its largest value (cv2 and PyTorch weigh the taps
  in f32 in other orders), masks, keypoints and validity equal.
* ``read_annotations`` and ``load_annotations_helper`` items equal to the
  JAX package's, the x/y scale fault of ``get_polygon_data`` included; the
  seeded train/test split equal; ``TrainLoader`` and ``eval_batches`` draw
  the same samples for a seed; ``to_yaml`` read back by the JAX
  ``ModelConfig.from_yaml``, equal.
'''
import dataclasses
import json
import os
import random
import struct
import zlib

import cv2
import numpy as np
import pytest

from moseq2_detectron_extract_tpu.io import annot as jannot
from moseq2_detectron_extract_tpu.models import data as jdata
from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
from moseq2_detectron_extract_tpu.proc.keypoints import default_keypoint_names
from moseq2_detectron_extract_tpu_torch.io import annot
from moseq2_detectron_extract_tpu_torch.io.image import read_image, read_png, write_image, \
    write_png
from moseq2_detectron_extract_tpu_torch.models import data
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views


# -- PNG ---------------------------------------------------------------------------

def _images(rng):
    return {'gray8': rng.integers(0, 256, (37, 53), dtype=np.uint8),
            'gray16': rng.integers(0, 65536, (40, 31), dtype=np.uint16),
            'bgr': rng.integers(0, 256, (30, 41, 3), dtype=np.uint8),
            'bgra': rng.integers(0, 256, (33, 29, 4), dtype=np.uint8),
            'smooth': (np.add.outer(np.arange(60), np.arange(70)) // 3 % 256).astype(np.uint8)}


@pytest.mark.parametrize('level', [0, 3, 9])
def test_png_reader_matches_cv2(tmp_path, level):
    for name, img in _images(np.random.default_rng(level)).items():
        path = str(tmp_path / f'{name}.png')
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        ours = read_png(path)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def _filtered_png(rows: np.ndarray, bpp: int, kinds) -> bytes:
    '''PNG IDAT bytes of (H, stride) uint8 rows, row y filtered with
    kinds[y % len(kinds)] (the PNG spec's encoders).'''
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prior
        elif kind == 3:
            f = row - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out += bytes([kind]) + bytes((f % 256).astype(np.uint8))
        prior = row
    return bytes(out)


def _chunk(kind, payload):
    return struct.pack('>I', len(payload)) + kind + payload + \
        struct.pack('>I', zlib.crc32(kind + payload) & 0xFFFFFFFF)


def _png_file(path, rows, width, height, bits, color, kinds, interlace=0):
    channels = {0: 1, 2: 3, 6: 4}[color]
    bpp = channels * bits // 8
    with open(path, 'wb') as fh:
        fh.write(b'\x89PNG\r\n\x1a\n'
                 + _chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, bits, color, 0, 0,
                                               interlace))
                 + _chunk(b'IDAT', zlib.compress(_filtered_png(rows, bpp, kinds)))
                 + _chunk(b'IEND', b''))


@pytest.mark.parametrize('kinds', [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_png_reader_undoes_every_row_filter(tmp_path, kinds):
    rng = np.random.default_rng(len(kinds) + kinds[0])
    rgb = rng.integers(0, 256, (23, 17, 3), dtype=np.uint8)
    path = str(tmp_path / 'f.png')
    _png_file(path, rgb.reshape(23, -1), 17, 23, 8, 2, kinds)
    np.testing.assert_array_equal(read_png(path), rgb[..., ::-1])     # BGR, as cv2
    np.testing.assert_array_equal(read_png(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))
    g16 = rng.integers(0, 65536, (9, 11), dtype=np.uint16)
    _png_file(path, g16.astype('>u2').view(np.uint8).reshape(9, -1), 11, 9, 16, 0, kinds)
    np.testing.assert_array_equal(read_png(path), g16)


def test_png_writer_read_back_by_cv2_and_interlace_raises(tmp_path):
    for name, img in _images(np.random.default_rng(9)).items():
        path = str(tmp_path / f'{name}.png')
        write_png(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img,
                                      err_msg=name)
    path = str(tmp_path / 'i.png')
    _png_file(path, np.zeros((4, 4), np.uint8), 4, 4, 8, 0, (0,), interlace=1)
    with pytest.raises(ValueError, match='interlaced'):
        read_png(path)
    with pytest.raises(ValueError):
        write_png(path, np.zeros((4, 4), np.float32))


def test_read_image_dispatches_png_and_tiff_with_the_scale_sidecar(tmp_path):
    depth = np.random.default_rng(1).uniform(600, 700, (20, 30))
    for ext in ('png', 'tiff'):
        path = str(tmp_path / f'd.{ext}')
        write_image(path, depth, scale=True, scale_factor=(500, 800))
        back = read_image(path)
        np.testing.assert_allclose(back, depth, atol=300 / 65535)
        with open(path, 'rb') as fh:
            assert fh.read(4) == (b'\x89PNG' if ext == 'png' else b'II*\x00')
    frame = np.random.default_rng(2).integers(0, 256, (12, 14)).astype(np.uint8)
    path = str(tmp_path / 'f_depth.png')
    write_image(path, frame, scale=False, dtype='uint8')
    np.testing.assert_array_equal(read_image(path), frame)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), frame)


# -- polygons ----------------------------------------------------------------------

def _polygon(rng, kind):
    n = int(rng.integers(3, 30))
    if kind == 'convex':
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(5, 40)
        return np.stack([60 + r * np.cos(ang) * rng.uniform(0.5, 1.5), 50 + r * np.sin(ang)], 1)
    if kind == 'concave':
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(3, 45, n)
        return np.stack([60 + r * np.cos(ang), 50 + r * np.sin(ang)], 1)
    if kind == 'thin':
        x, y = rng.uniform(5, 110, 2), rng.uniform(5, 90, 2)
        w = rng.uniform(0.2, 2.0)
        return np.array([[x[0], y[0]], [x[1], y[1]], [x[1] + w, y[1] + w * 0.3],
                         [x[0] + w, y[0] + w * 0.3]])
    if kind == 'self-crossing':
        return rng.uniform(0, 99, (n // 2 + 3, 2))
    # crossing the image's edge, as the reference's x/y fault makes polygons
    # of non-square frames do
    return np.stack([rng.uniform(-40, 160, n // 2 + 3), rng.uniform(-40, 140, n // 2 + 3)], 1)


@pytest.mark.parametrize('kind', ['convex', 'concave', 'thin', 'self-crossing',
                                  'off-image'])
def test_poly_to_mask_equals_cv2_fill_poly(kind):
    rng = np.random.default_rng(len(kind))
    for _ in range(60):
        poly = _polygon(rng, kind)
        ref = np.zeros((100, 120), np.uint8)
        cv2.fillPoly(ref, [np.round(poly).astype(np.int32).reshape(-1, 1, 2)], 1)
        np.testing.assert_array_equal(annot.poly_to_mask(poly, (100, 120))[..., 0], ref)


def test_point_in_polygon_equals_cv2():
    rng = np.random.default_rng(3)
    for _ in range(200):
        poly = rng.uniform(0, 50, (int(rng.integers(3, 9)), 2)).astype(np.float32)
        for q in (rng.uniform(0, 50, 2), poly[0], (poly[0] + poly[1]) / 2,
                  np.round(rng.uniform(0, 50, 2))):
            ref = cv2.pointPolygonTest(poly.reshape(-1, 1, 2), (float(q[0]), float(q[1])),
                                       False) >= 0
            assert annot.point_in_polygon(q, poly) == ref


# -- annotations, samples, loaders ----------------------------------------------------

def _non_square_export(tmp_path):
    '''Two 40x64 (h x w) views: the reference's x/y scale fault moves their
    polygons.'''
    tasks = []
    for i in range(2):
        name = f'v{i}_depth.png'
        write_image(str(tmp_path / name), np.full((40, 64), 30 + i, np.uint8), scale=False,
                    dtype='uint8')
        base = {'original_width': 64, 'original_height': 40}
        result = [dict(base, type='polygonlabels',
                       value={'points': [[20, 10], [60, 15], [55, 50], [25, 45]]}),
                  dict(base, type='polygonlabels',
                       value={'points': [[70, 60], [90, 60], [90, 70]]}),
                  dict(base, type='keypointlabels', value={'x': 40, 'y': 30,
                                                           'keypointlabels': ['Nose']}),
                  dict(base, type='keypointlabels', value={'x': 85, 'y': 90,
                                                           'keypointlabels': ['TailTip']})]
        tasks.append({'id': f't{i}', 'data': {'depth_image': str(tmp_path / f'ab12-{name}')},
                      'annotations': [{'result': result}]})
    path = str(tmp_path / 'ns.json')
    with open(path, 'w', encoding='utf-8') as fh:
        json.dump(tasks, fh)
    return path


def test_read_annotations_items_equal_jax(tmp_path):
    export = write_annotated_views(str(tmp_path / 'views'), 5, size=40, seed=1)
    for path in (export, _non_square_export(tmp_path)):
        for fmt in ('polygon', 'bitmask'):
            ours = annot.read_annotations(path, default_keypoint_names, mask_format=fmt)
            ref = jannot.read_annotations(path, default_keypoint_names, mask_format=fmt)
            assert len(ours) == len(ref)
            for o, r in zip(ours, ref):
                assert {k: v for k, v in o.items() if k != 'annotations'} == \
                    {k: v for k, v in r.items() if k != 'annotations'}
                for oa, ra in zip(o['annotations'], r['annotations']):
                    assert oa.keys() == ra.keys()
                    for key in oa:
                        np.testing.assert_array_equal(np.asarray(oa[key]), np.asarray(ra[key]))
    # the fault: a polygon's x scaled by the height (40), its y by the width (64)
    item = annot.read_annotations(_non_square_export(tmp_path), default_keypoint_names)[0]
    assert item['annotations'][0]['segmentation'][0][:2] == [20 * 40 / 100, 10 * 64 / 100]


def test_load_annotations_helper_and_split_equal_jax(tmp_path):
    export = write_annotated_views(str(tmp_path / 'views'), 11, size=48, seed=2)
    moved = str(tmp_path / 'moved')
    os.rename(str(tmp_path / 'views'), moved)
    replace = [(str(tmp_path / 'views'), moved)]
    out = {}
    for name, mod in (('ours', annot), ('ref', jannot)):
        random.seed(5)
        items = mod.load_annotations_helper([os.path.join(moved, 'export.json')], 'RGB',
                                            replace_paths=replace, register=True)
        out[name] = ([it['image_id'] for it in items],
                     [it['image_id'] for it in mod.dataset_catalog_get('moseq_train')],
                     [it['image_id'] for it in mod.dataset_catalog_get('moseq_test')],
                     [it['file_name'] for it in items])
        assert mod.metadata_catalog_get('moseq_train')['keypoint_names'] == \
            default_keypoint_names
    assert out['ours'] == out['ref']
    assert len(out['ours'][1]) == 9 and len(out['ours'][2]) == 2
    with pytest.raises(FileNotFoundError):
        annot.load_annotations_helper([export.replace('views', 'moved')], 'RGB', register=False,
                                      show_info=False)
    images = [read_image(f) for f in out['ours'][3]]
    assert np.asarray(annot.get_dataset_statistics(
        [{'file_name': f} for f in out['ours'][3]], 'L')[0])[0] == \
        pytest.approx(np.mean([i.mean() for i in images]))


def _configs(**kw):
    base = dict(image_size=64, min_size_train=60, max_size_train=64, max_gt_instances=2,
                ims_per_batch=3)
    base.update(kw)
    return ModelConfig(**base), JaxModelConfig(**base)


@pytest.mark.parametrize('size,rescale', [(48, 1.0), (150, 0.5), (64, 1.0)])
def test_load_sample_matches_jax(tmp_path, size, rescale):
    export = write_annotated_views(str(tmp_path / 'v'), 3, size=size, seed=size)
    cfg, jcfg = _configs()
    for item in annot.read_annotations(export, default_keypoint_names, rescale=rescale):
        ours = data.load_sample(item, cfg)
        ref = jdata.load_sample(item, jcfg)
        img_err = np.abs(ours['image'] - ref['image']).max()
        assert img_err <= 1e-4 * max(np.abs(ref['image']).max(), 1.0), img_err
        for key in ('masks', 'keypoints', 'valid'):
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
        assert ours['valid'][0] and not ours['valid'][1]


def test_loaders_draw_the_same_batches_as_jax(tmp_path):
    export = write_annotated_views(str(tmp_path / 'v'), 7, size=56, seed=4)
    items = annot.read_annotations(export, default_keypoint_names)
    cfg, jcfg = _configs()
    ours, ref = data.TrainLoader(items, cfg, seed=3), jdata.TrainLoader(items, jcfg, seed=3)
    try:
        for _ in range(3):
            o, r = next(ours), next(ref)
            np.testing.assert_array_equal(o['masks'], r['masks'])
            np.testing.assert_array_equal(o['keypoints'], r['keypoints'])
            np.testing.assert_allclose(o['image'], r['image'], atol=1e-4 * r['image'].max())
    finally:
        ours.close()
        ref.close()
    assert not ours._thread.is_alive()
    o_eval, r_eval = data.eval_batches(items, cfg), jdata.eval_batches(items, jcfg)
    assert [b['n_true'] for b in o_eval] == [b['n_true'] for b in r_eval] == [3, 3, 1]
    for o, r in zip(o_eval, r_eval):
        np.testing.assert_array_equal(o['masks'], r['masks'])
        np.testing.assert_allclose(o['image'], r['image'], atol=1e-4 * r['image'].max())
    with pytest.raises(ValueError):
        data.TrainLoader([], cfg)


def test_to_yaml_is_read_by_the_jax_config(tmp_path):
    cfg = ModelConfig(resnet_stage_blocks=(1, 2, 3, 1), amp_dtype='float32', base_lr=0.0125,
                      lr_steps=(5, 9), keypoint_names=('a b', 'c'), warmup_factor=1e-3)
    path = str(tmp_path / 'config.yaml')
    cfg.to_yaml(path)
    assert dataclasses.asdict(JaxModelConfig.from_yaml(path)) == dataclasses.asdict(cfg)
    assert ModelConfig.from_yaml(path) == cfg
