'''The slice as a whole: the port's ``process_chunk`` against the JAX package's
``InferenceStep`` + ``SelectInstancesStep`` (which runs
``dispatch_instance_features``) on one sentinel-encoded chunk, with the
committed tiny trained model, on the CPU.

Both sides compute the model in f32 (``amp_dtype`` replaced), so the
comparison is about the port's algorithm; pooling is bf16 on both sides.
What differs by design: the JAX package pools with bf16 interpolation
weights and a bf16 intermediate, the port in f32 rounded once (see
test_torch_roi_align), so head outputs differ at the bf16 level: scores
2e-3, boxes 0.5 px at frame scale (2.5 x 0.2 px on the 64-px canvas), mask
probabilities 0.05; thresholded masks may flip at a few boundary pixels (at
most 1% of each mask); a keypoint sits within 0.5 px, or one heatmap bin
away where two bins of its heatmap nearly tie (at most 1 in 20 keypoints).
Window origins, the number of instances and the decoded depth windows are
held exactly; the cleaned windows exactly where they are zero-bordered (there
the fused clean equals the JAX ops path); the window masks to the mask flips
above, and their moments to match (centroid and axes 0.5 px, orientation
0.02 rad).
'''
import os

import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
from moseq2_detectron_extract_tpu.models.checkpoint import load_params_npz
from moseq2_detectron_extract_tpu.models.predictor import Predictor as JaxPredictor
from moseq2_detectron_extract_tpu.pipeline.steps import InferenceStep, SelectInstancesStep
from moseq2_detectron_extract_tpu_torch.extract import process_chunk
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
from moseq2_detectron_extract_tpu_torch.models.weights import (load_params_npz as
                                                               port_load_npz,
                                                               params_from_jax)
from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk

from tests.test_torch_common import port_config

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
N, H, W = 8, 128, 128
CONFIG = {'min_height': 0, 'max_height': 255, 'feature_window': 96,
          'expected_instances': 1}


@pytest.fixture(scope='module')
def both(tmp_path_factory):
    cfg = JaxModelConfig.from_yaml(os.path.join(DATA, 'tiny_overfit_config.yaml')) \
        .replace(amp_dtype='float32')
    npz = os.path.join(DATA, 'tiny_overfit_params.npz')
    chunk = make_sentinel_chunk(N, H, W, seed=3, axes=(20.0, 10.0))

    ours = process_chunk(chunk.copy(), Predictor(
        port_config(cfg), params_from_jax(port_load_npz(npz)), batch_size=4,
        device='cpu'), CONFIG)

    jcfg = dict(CONFIG, predictor=JaxPredictor(cfg, load_params_npz(npz), batch_size=4),
                output_dir=str(tmp_path_factory.mktemp('slice')))
    inference = InferenceStep('inference', config=jcfg)
    inference.initialize()
    data = inference.process({'chunk': chunk.copy(), 'frame_idxs': np.arange(N),
                              'offset': 0})
    select = SelectInstancesStep('select', config=jcfg)
    select.initialize()
    ref = select.process(data)
    select.finalize()
    return ours, ref


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_keypoints_close(ours, ref, boxes, heatmap_size=28):
    '''(N, K, 2) keypoints: within 0.5 px, or one heatmap bin of the box.'''
    diff = np.abs(ours - ref)
    valid = np.isfinite(ref).all(axis=-1)
    bin_size = (boxes[:, 2:4] - boxes[:, 0:2]) / heatmap_size      # (N, 2 [x, y])
    assert (diff[valid] <= np.broadcast_to(bin_size[:, None] + 0.5, diff.shape)[valid]).all()
    assert (diff[valid].max(axis=-1) > 0.5).mean() <= 0.05


def _zero_bordered(windows, band=14):
    '''Per window: no non-zero pixel within ``band`` px of its edge, where
    the fused clean's zero halo and the cv2-border ops path agree.'''
    inner = np.zeros(windows.shape[1:], bool)
    inner[band:-band, band:-band] = True
    return ~(windows.astype(bool) & ~inner).any(axis=(1, 2))


def test_detections(both):
    ours, ref = both
    a, b = ours['inference'], ref['inference']
    assert _np(a['valid']).sum() >= N - 2             # the mouse found in most frames
    assert _np(a['boxes']).shape == (N, 1, 4)
    for key in ('valid', 'keep', 'classes'):
        np.testing.assert_array_equal(_np(a[key]), _np(b[key]))
    np.testing.assert_allclose(_np(a['scores']), _np(b['scores']), atol=2e-3)
    np.testing.assert_allclose(_np(a['boxes']), _np(b['boxes']), atol=0.5)
    _assert_keypoints_close(_np(a['keypoints'])[:, 0, :, :2], _np(b['keypoints'])[:, 0, :, :2],
                            _np(b['boxes'])[:, 0])
    np.testing.assert_allclose(_np(a['mask_probs']), _np(b['mask_probs']), atol=0.05)
    flips = (_np(a['masks']) != _np(b['masks'])).sum(axis=(2, 3))
    assert (flips <= 0.01 * _np(b['masks']).sum(axis=(2, 3))).all(), flips


def test_selection_and_windows(both):
    ours, ref = both
    for key in ('num_instances', 'win_origins'):
        np.testing.assert_array_equal(ours[key], ref[key])
    np.testing.assert_array_equal(_np(ours['raw_windows']), _np(ref['raw_windows']))
    assert _zero_bordered(_np(ours['raw_windows']))[ours['num_instances'] > 0].all()
    flips = (_np(ours['sel_masks']) != _np(ref['sel_masks'])).sum(axis=(1, 2))
    assert (flips <= 0.01 * _np(ref['sel_masks']).sum(axis=(1, 2))).all(), flips
    boxes = _np(ref['inference']['boxes'])[:, 0]      # one detection per image
    _assert_keypoints_close(_np(ours['sel_keypoints'])[..., :2],
                            _np(ref['sel_keypoints'])[..., :2], boxes)


def test_window_features(both):
    ours, ref = both
    a, b = ours['feat_dispatch'], ref['feat_dispatch']
    bordered = _zero_bordered(_np(ours['raw_windows']))
    assert bordered.sum() >= N - 2
    np.testing.assert_array_equal(_np(a['cleaned_frames'])[bordered],
                                  _np(b['cleaned_frames'])[bordered])
    flips = (_np(a['feat_masks']) != _np(b['feat_masks'])).sum(axis=(1, 2))
    assert (flips <= 0.01 * _np(b['feat_masks']).sum(axis=(1, 2))).all(), flips
    # centroid and axes of masks that agree to 1%: within 0.5 px
    for key in ('centroid', 'axis_length'):
        np.testing.assert_allclose(_np(a['feats_dev'][key]), _np(b['feats_dev'][key]),
                                   atol=0.5)
    np.testing.assert_allclose(_np(a['feats_dev']['orientation']),
                               _np(b['feats_dev']['orientation']), atol=0.02)
