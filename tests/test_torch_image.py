'''The port's TIFF caches against the JAX package's (cv2, LZW with
horizontal differencing): each reads the other's files equal, with the
``.scale.json`` sidecar's scaling.'''
import cv2
import numpy as np
import pytest

from moseq2_detectron_extract_tpu.io.image import read_tiff_image as jax_read
from moseq2_detectron_extract_tpu.io.image import write_image as jax_write
from moseq2_detectron_extract_tpu_torch.io.image import (lzw_decode, read_tiff, read_tiff_image,
                                                        write_image, write_tiff)

SHAPES = [(128, 192), (424, 512), (7, 3)]


def random_image(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize('dtype', ['uint8', 'uint16'])
@pytest.mark.parametrize('shape', SHAPES)
def test_port_tiff_reads_equal_through_cv2(tmp_path, dtype, shape):
    image = random_image(shape, dtype, seed=sum(shape))
    path = str(tmp_path / 'port.tiff')
    write_tiff(path, image)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == image.dtype
    np.testing.assert_array_equal(got, image)
    np.testing.assert_array_equal(read_tiff(path), image)


@pytest.mark.parametrize('dtype', ['uint8', 'uint16'])
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('content', ['random', 'smooth'])
def test_cv2_lzw_tiff_reads_equal_through_port(tmp_path, dtype, shape, content):
    '''cv2 writes LZW (compression 5) with predictor 2; a random image fills
    the LZW table and clears it, a smooth one compresses well.'''
    if content == 'random':
        image = random_image(shape, dtype, seed=3)
    else:
        image = (np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1])) % 200).astype(dtype)
    path = str(tmp_path / 'cv2.tiff')
    cv2.imwrite(path, image)
    with open(path, 'rb') as fh:
        assert b'\x03\x01\x03\x00\x01\x00\x00\x00\x05\x00' in fh.read()   # tag 259 = 5
    got = read_tiff(path)
    assert got.dtype == image.dtype
    np.testing.assert_array_equal(got, image)


@pytest.mark.parametrize('dtype,scale_factor', [('uint16', None), ('uint16', (650, 750)),
                                                ('uint8', 255), ('uint16', 800.0)])
def test_scaled_images_cross_read(tmp_path, dtype, scale_factor):
    '''A depth image written by either package reads the same through both.'''
    rng = np.random.default_rng(5)
    image = rng.uniform(600, 800, (128, 192))
    if dtype == 'uint8':
        image = (image > 700).astype('uint8') * 255
    for writer, name in ((write_image, 'port'), (jax_write, 'jax')):
        path = str(tmp_path / f'{name}.tiff')
        writer(path, image, scale=True, scale_factor=scale_factor, dtype=dtype)
        ours, ref = read_tiff_image(path), jax_read(path)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(read_tiff_image(str(tmp_path / 'port.tiff')),
                                  read_tiff_image(str(tmp_path / 'jax.tiff')))
    with open(str(tmp_path / 'port.tiff.scale.json')) as a, \
            open(str(tmp_path / 'jax.tiff.scale.json')) as b:
        assert a.read() == b.read()


def test_unscaled_read_and_missing_file(tmp_path):
    image = random_image((9, 11), 'uint16', 0)
    path = str(tmp_path / 'plain.tiff')
    write_image(path, image, scale=False)
    np.testing.assert_array_equal(read_tiff_image(path), jax_read(path))
    with pytest.raises(FileNotFoundError):
        read_tiff_image(str(tmp_path / 'absent.tiff'))
    with pytest.raises(ValueError):
        write_tiff(str(tmp_path / 'bad.tiff'), np.zeros((2, 2), 'float32'))


def test_lzw_decode_known_stream():
    '''Codes 9 bits MSB first: clear, 'A', 'B', 258 ('AB'), end.'''
    codes = [256, 65, 66, 258, 257]
    bits = ''.join(f'{c:09b}' for c in codes)
    bits += '0' * (-len(bits) % 8)
    data = int(bits, 2).to_bytes(len(bits) // 8, 'big')
    assert lzw_decode(data) == b'ABAB'
