'''The preview written: render, encode, ``extract`` and the two preview
commands, on the CPU against the JAX package.

* The render: the port's ``PreviewVideoWriterStep`` and the JAX package's
  render the same chunks (the seed-9 session of
  ``test_torch_extract_session.py``: the reference's selection, then the
  port's back end, chained), each step's ``_forward`` replaced to keep its
  composites. Equal: every primitive equals cv2 5.0 (``test_torch_viz.py``).
* The encoder: cv2 (its FFmpeg backend) decodes the port's AVI with every
  frame, the fps and the size, each frame's PSNR against the stamped
  composite no more than ``PSNR_MARGIN_DB`` below that of cv2's own JPEG
  (libjpeg) at the same quality and 4:2:0, decoded by libjpeg (both about
  29-35 dB here: the saturated jet colours lose most to the chroma
  subsampling; measured up to 0.6 dB below it through FFmpeg's decoder,
  which upsamples the chroma more simply than libjpeg); the C++
  colour conversion, DCT and
  quantisation equal the plain numpy version; past a small ``riff_limit``
  the OpenDML RIFFs decode with every frame.
* ``extract`` end to end: the port's ``extract_session`` writes
  ``results_00.avi`` with the session's frames, and ``stage_stats`` names
  the JAX pipeline's eight stages.
* The commands: ``visualize-raw`` writes the frames that the JAX package's
  ``generate_raw_preview`` gives its writer (colormapped and stamped by the
  JAX writer's own ``_frame_to_rgb``), equal; ``visualize-result`` those of
  ``H5ResultPreviewVideoGenerator`` on the port's results file: the crop
  panels equal, the rebuilt arena equal but where the reverse warp's f32
  value sits on a colour step (``ARENA_SHARE``).
* ``reverse_crop_and_rotate_frames`` against the same two warps computed in
  f64 (1e-3: the f32 sample coordinates round by up to 2e-5 px, times the
  frames' gradients; measured 5.2e-4), and against the JAX package's to the
  same 1e-3 but at a share of at most 1e-4 of the pixels (measured 1 of
  256,000, 3.97 off: there XLA's fused arithmetic puts a sample a rounding
  on the other side of a whole pixel, and the port's value is the f64
  one).
'''
import os

import cv2
import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu.pipeline import steps as jsteps
from moseq2_detectron_extract_tpu_torch.io import mjpeg
from moseq2_detectron_extract_tpu_torch.io.session import Session
from moseq2_detectron_extract_tpu_torch.pipeline import steps as psteps

from tests.synthetic import make_background
from tests.test_torch_extract_session import (CONFIG, NFRAMES, _extract_config, _to_port,
                                              jax_chunks, make_predictors,
                                              write_synthetic_session)
from tests.test_torch_output_ops import smooth_frames

PSNR_MARGIN_DB = 1.0
ARENA_SHARE = 0.999
FONT = cv2.FONT_HERSHEY_SIMPLEX


@pytest.fixture(scope='module')
def session_path(tmp_path_factory):
    return write_synthetic_session(str(tmp_path_factory.mktemp('raw9')), nframes=NFRAMES, seed=9)


@pytest.fixture(scope='module')
def chained(session_path, tmp_path_factory):
    '''Each chunk as the preview receives it: the reference's selection,
    the port's back end, the host chunk with its sentinels zeroed.'''
    from moseq2_detectron_extract_tpu_torch.extract import prepare_session
    port_pred, jax_pred = make_predictors()
    session = Session(session_path)
    session._bground_im = make_background()
    prepared = prepare_session(session, CONFIG, device='cpu')
    _, ref = jax_chunks(session_path, jax_pred, CONFIG, str(tmp_path_factory.mktemp('jax')))
    trackers = psteps.make_feature_trackers(prepared)
    chunks = []
    for b in ref:
        ours = psteps.fetch_results(psteps.process_features(_to_port(b), prepared, trackers),
                                    prepared)
        chunks.append(dict(ours, chunk=np.asarray(b['fetched']['chunk']), offset=b['offset'],
                           kept_boxes=np.asarray(b['kept_boxes'])))
    config = dict(prepared, output_dir=str(tmp_path_factory.mktemp('preview')), bg_roi_index=0)
    return chunks, config


def _render(step_cls, chunks, config):
    '''The step's composites and their frame numbers, copied as it forwards
    them (the composites are ring buffers).'''
    step = step_cls(step_name='preview', config=config)
    step.output_queues = []
    kept = []
    step._forward = lambda item: kept.append((np.array(item['frame_idxs']),
                                              np.array(item['composite'])))
    step.initialize()
    for data in chunks:
        step.process(data)
    return kept


def test_render_equals_jax(chained):
    chunks, config = chained
    ours = _render(psteps.PreviewVideoWriterStep, chunks, config)
    ref = _render(jsteps.PreviewVideoWriterStep, chunks, dict(config))
    assert [len(i) for i, _ in ours] == [len(i) for i, _ in ref] == [32, 8]
    for (oi, oc), (ri, rc) in zip(ours, ref):
        np.testing.assert_array_equal(oi, ri)
        assert oc.shape == rc.shape and oc.dtype == np.uint8
        np.testing.assert_array_equal(oc, rc)
    assert ours[0][1].any()


def _decode(path):
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    info = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return info, np.array(frames)


def _psnr(a, b):
    mse = ((a.astype(np.float64) - b) ** 2).mean(axis=tuple(range(1, a.ndim)))
    return 10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12))


def _libjpeg_psnr(frames):
    '''Each BGR frame's PSNR through cv2's own JPEG (libjpeg) at the port's
    quality and 4:2:0.'''
    out = []
    for frame in frames:
        _, jpeg = cv2.imencode('.jpg', frame, [cv2.IMWRITE_JPEG_QUALITY, mjpeg.DEFAULT_QUALITY,
                                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        out.append(_psnr(cv2.imdecode(jpeg, cv2.IMREAD_COLOR)[None], frame[None])[0])
    return np.array(out)


def _stamped(composites, idxs):
    '''The composites as the JAX writer pads and stamps them (zeros to even
    sizes, then cv2.putText), BGR.'''
    n, h, w = composites.shape[:3]
    out = np.pad(composites, ((0, 0), (0, h % 2), (0, w % 2), (0, 0)))
    for frame, idx in zip(out, idxs):
        cv2.putText(frame, str(int(idx)), (5, frame.shape[0] - 40), FONT, 1, (255, 255, 255),
                    2, cv2.LINE_AA)
    return out


@pytest.mark.parametrize('riff_limit', [mjpeg.RIFF_LIMIT, 150_000],
                         ids=['avi1', 'opendml'])
def test_encoded_avi_decodes(chained, riff_limit, tmp_path):
    from moseq2_detectron_extract_tpu_torch.io.video import PreviewVideoWriter
    chunks, config = chained
    blocks = _render(psteps.PreviewVideoWriterStep, chunks, config)
    path = str(tmp_path / 'results_00.avi')
    writer = PreviewVideoWriter(path, fps=30, channel_order='bgr', riff_limit=riff_limit)
    for idxs, comp in blocks:
        writer.write_frames(idxs, comp.copy(), writable=True)
    writer.close()
    idxs = np.concatenate([i for i, _ in blocks])
    expect = _stamped(np.concatenate([c for _, c in blocks]), idxs)
    (count, fps, width, height), decoded = _decode(path)
    assert (count, fps, width, height) == (NFRAMES, 30.0, expect.shape[2], expect.shape[1])
    assert decoded.shape == expect.shape
    psnr, libjpeg = _psnr(decoded, expect), _libjpeg_psnr(expect)
    print(f'PSNR {psnr.min():.2f}-{psnr.max():.2f} dB over {len(psnr)} frames '
          f'(cv2.imencode at the same quality and subsampling: {libjpeg.min():.2f}-'
          f'{libjpeg.max():.2f}); {os.path.getsize(path) / NFRAMES / 1e3:.1f} KB a frame')
    assert (psnr >= libjpeg - PSNR_MARGIN_DB).all()
    index = mjpeg.read_avi_index(path)
    assert len(index['frames']) == index['dmlh_frames'] == index['strh_length'] == NFRAMES
    assert index['jpeg_ok'] and sum(index['super']) == NFRAMES
    if riff_limit < mjpeg.RIFF_LIMIT:
        assert index['riffs'][0] == 'AVI ' and set(index['riffs'][1:]) == {'AVIX'}
        assert len(index['riffs']) > 1 and index['avih_frames'] == index['idx1'] < NFRAMES
    else:
        assert index['riffs'] == ['AVI '] and index['idx1'] == NFRAMES


@pytest.mark.parametrize('order', ['rgb', 'bgr'])
def test_jpeg_forward_equals_plain(chained, order):
    chunks, config = chained
    frame = _render(psteps.PreviewVideoWriterStep, chunks[1:], config)[0][1][3]
    for quality in (90, 50):
        np.testing.assert_array_equal(mjpeg.forward_coefficients_native(frame, quality, order),
                                      mjpeg.forward_coefficients(frame, quality, order))
    odd = np.ascontiguousarray(frame[:37, :45])
    np.testing.assert_array_equal(mjpeg.forward_coefficients_native(odd, 75, order),
                                  mjpeg.forward_coefficients(odd, 75, order))


@pytest.fixture(scope='module')
def extracted(session_path, tmp_path_factory):
    '''The port's ``extract`` command on the session with the tiny model.'''
    import shutil
    from moseq2_detectron_extract_tpu_torch import cli
    from tests.test_torch_extract_session import DATA, JaxModelConfig
    model_dir = tmp_path_factory.mktemp('model')
    JaxModelConfig.from_yaml(os.path.join(DATA, 'tiny_overfit_config.yaml')) \
        .replace(amp_dtype='float32').to_yaml(str(model_dir / 'config.yaml'))
    shutil.copy(os.path.join(DATA, 'tiny_overfit_params.npz'), str(model_dir / 'params_f16.npz'))
    out_dir = str(tmp_path_factory.mktemp('extract'))
    assert cli.main(['extract', session_path, '--model', str(model_dir), '--device', 'cpu',
                     '--chunk-size', '32', '--output-dir', out_dir]) == 0
    return out_dir


def test_extract_writes_the_preview(extracted):
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml
    status = read_yaml(os.path.join(extracted, 'results_00.yaml'))
    assert status['complete'] is True
    assert sorted(status['stage_stats']) == sorted(
        ['Read Depth Data', 'Model Inference', 'Instance Select', 'Process Features',
         'Fetch Results', 'Preview Video', 'Preview Encode', 'Write Reults'])
    assert set(status['stage_stats']['Preview Video']['sub_times']) == {'marshal', 'render'}
    path = os.path.join(extracted, 'results_00.avi')
    (count, fps, width, height), decoded = _decode(path)
    assert count == len(decoded) == NFRAMES and fps == 30.0
    index = mjpeg.read_avi_index(path)
    assert len(index['frames']) == NFRAMES and index['jpeg_ok']
    assert (index['width'], index['height']) == (width, height)


def test_extract_raises_when_the_encoder_cannot_load(session_path, tmp_path, monkeypatch):
    '''A failed load of the encoder is a failed extraction, not a session
    without a preview.'''
    from moseq2_detectron_extract_tpu_torch import native
    from moseq2_detectron_extract_tpu_torch.extract import extract_session
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml

    def broken():
        raise RuntimeError('g++ failed: the encoder does not build')

    monkeypatch.setattr(native, 'load_mjpeg_library', broken)
    port_pred, _ = make_predictors()
    session = Session(session_path)
    session._bground_im = make_background()
    status = extract_session(session, _extract_config(str(tmp_path), port_pred))
    assert read_yaml(status)['complete'] is False
    with open(os.path.join(str(tmp_path), 'results_00.log'), encoding='utf-8') as fh:
        assert 'the encoder does not build' in fh.read()


class _Captured:
    '''Frames handed to a writer's ``write_frames``, kept in order.'''

    def __init__(self):
        self.frames = []

    def jax(self, writer, frame_idxs, frames, writable=False):
        '''The JAX writer's frames as it would encode them (its own
        ``_frame_to_rgb``: colormap, then the cv2 stamp), RGB.'''
        frames = np.asarray(frames)
        pad = [(0, 0), (0, frames.shape[1] % 2), (0, frames.shape[2] % 2)]
        frames = np.pad(frames, pad + [(0, 0)] * (frames.ndim - 3))
        for idx, frame in zip(frame_idxs, frames):
            self.frames.append(writer._frame_to_rgb(np.array(frame), int(idx)))

    def port(self, avi, frames, order='rgb'):
        self.frames.extend(np.array(frames))


@pytest.fixture
def capture(monkeypatch):
    from moseq2_detectron_extract_tpu.io.video import PreviewVideoWriter as JaxWriter
    ours, ref = _Captured(), _Captured()
    monkeypatch.setattr(JaxWriter, 'write_frames', lambda self, i, f, writable=False:
                        ref.jax(self, i, f, writable))
    monkeypatch.setattr(JaxWriter, 'close', lambda self: None)
    write = mjpeg.MjpegAviWriter.write_frames

    def keep(self, frames, order='rgb'):
        ours.port(self, frames, order)
        write(self, frames, order)

    monkeypatch.setattr(mjpeg.MjpegAviWriter, 'write_frames', keep)
    return ours, ref


def test_visualize_raw_equals_jax(session_path, tmp_path, capture):
    from moseq2_detectron_extract_tpu import viz as jviz
    from moseq2_detectron_extract_tpu_torch import cli
    ours, ref = capture
    out = str(tmp_path / 'preview.avi')
    assert cli.main(['visualize-raw', session_path, '-o', out, '--chunk-size', '16',
                     '--device', 'cpu']) == 0
    jviz.generate_raw_preview(session_path, str(tmp_path / 'ref.mp4'), chunk_size=16)
    assert len(ours.frames) == len(ref.frames) == NFRAMES
    np.testing.assert_array_equal(np.array(ours.frames), np.array(ref.frames))
    (count, _, _, _), decoded = _decode(out)
    assert count == NFRAMES
    expect = np.array(ref.frames)[..., ::-1]
    assert (_psnr(decoded, expect) >= _libjpeg_psnr(expect) - PSNR_MARGIN_DB).all()


def test_visualize_result_equals_jax(extracted, tmp_path, capture):
    from moseq2_detectron_extract_tpu import viz as jviz
    from moseq2_detectron_extract_tpu_torch import cli
    ours, ref = capture
    h5 = os.path.join(extracted, 'results_00.h5')
    out = str(tmp_path / 'result.avi')
    assert cli.main(['visualize-result', h5, '-o', out, '--chunk-size', '16',
                     '--device', 'cpu']) == 0
    jviz.H5ResultPreviewVideoGenerator(h5, str(tmp_path / 'ref.mp4'), chunk_size=16).generate()
    ours_f, ref_f = np.array(ours.frames), np.array(ref.frames)
    assert ours_f.shape == ref_f.shape and len(ours_f) == NFRAMES
    import h5py
    with h5py.File(h5, 'r') as fh:
        xs = np.nonzero(fh['metadata/extraction/roi'][()] > 0)[1]
    dest_w = int(xs.max() - xs.min())
    np.testing.assert_array_equal(ours_f[:, :, dest_w:], ref_f[:, :, dest_w:])
    same = (ours_f[:, :, :dest_w] == ref_f[:, :, :dest_w]).all(-1).mean()
    print(f'rebuilt arena: {same:.6f} of the pixels equal')
    assert same >= ARENA_SHARE
    assert _decode(out)[0][0] == NFRAMES


def _reverse_f64(frames, centers, angles, dest):
    '''The two warps of ``reverse_crop_and_rotate_frames`` in f64 numpy, on
    the port's f32 rotation matrices.'''
    from moseq2_detectron_extract_tpu_torch.ops import warp
    n, ch, cw = frames.shape
    dest_w, dest_h = dest
    inv = warp._invert_affine(warp._cv2_rotation_matrix(
        (cw // 2, ch // 2), -torch.as_tensor(np.nan_to_num(angles), dtype=torch.float32))) \
        .double().numpy()
    yy, xx = np.mgrid[0:dest_h, 0:dest_w].astype(np.float64)

    def sample(img, x, y, w, h):
        x0, y0 = np.floor(x), np.floor(y)
        fx, fy = x - x0, y - y0
        out = 0
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                xi, yi = (x0 + dx).astype(int), (y0 + dy).astype(int)
                inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                out = out + wy * wx * np.where(inside, img[np.clip(yi, 0, h - 1),
                                                           np.clip(xi, 0, w - 1)], 0)
        return out

    result = np.zeros((n, dest_h, dest_w))
    for i in range(n):
        if np.isnan(angles[i]) or np.isnan(centers[i]).any():
            continue
        m = inv[i]
        stage1 = sample(frames[i].astype(np.float64), m[0, 0] * xx + m[0, 1] * yy + m[0, 2],
                        m[1, 0] * xx + m[1, 1] * yy + m[1, 2], cw, ch)
        tx = np.float64(np.float32(centers[i, 0]) - np.float32(cw // 2))
        ty = np.float64(np.float32(centers[i, 1]) - np.float32(ch // 2))
        result[i] = sample(stage1, xx - tx, yy - ty, dest_w, dest_h)
    return result


def test_reverse_crop_and_rotate_frames():
    import jax.numpy as jnp
    from moseq2_detectron_extract_tpu.ops import warp as jwarp
    from moseq2_detectron_extract_tpu_torch.ops import warp as pwarp
    crops = smooth_frames(8, h=80, w=80).astype(np.float32)
    centers = np.array([[100.3, 80.7], [10, 5], [190, 150], [50, 60], [np.nan, 3],
                        [120.5, 33.2], [0, 0], [150, 100]])
    angles = np.array([0, 33.3, 90, -45, 10, 181.7, np.nan, 359.9])
    ours = pwarp.reverse_crop_and_rotate_frames(torch.from_numpy(crops), centers, angles,
                                                (200, 160))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (8, 160, 200)
    ours = ours.numpy()
    np.testing.assert_allclose(ours, _reverse_f64(crops, centers, angles, (200, 160)),
                               rtol=0, atol=1e-3)
    assert not ours[4].any() and not ours[6].any() and ours[0].any()
    ref = np.asarray(jwarp.reverse_crop_and_rotate_frames(
        jnp.asarray(crops), jnp.asarray(centers), jnp.asarray(angles), (200, 160)))
    off = np.abs(ours - ref) > 1e-3
    print(f'pixels more than 1e-3 from the JAX package: {int(off.sum())} of {off.size}')
    assert off.mean() <= 1e-4
