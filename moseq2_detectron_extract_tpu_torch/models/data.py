'''The host side of training: annotated samples into fixed-shape batches.

Port of ``moseq2_detectron_extract_tpu/models/data.py``. A sample's image
is read (with its intensity scale), resized to the train canvas's content
size and padded; its polygons are rasterised (``io.annot.poly_to_mask``)
and resized nearest. The batches go to the device, where the augmentations
run (``models/augment.py``).

The image resize is cv2's ``resize(..., INTER_LINEAR)`` on float32 (the
reference's): half-pixel centres, the ratio ``w / new_w`` per axis, no
antialiasing. ``F.interpolate(mode='bilinear', align_corners=False,
antialias=False)`` at the explicit size computes the same.
'''
import queue as queue_mod
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from moseq2_detectron_extract_tpu_torch.io.annot import DataItem, poly_to_mask
from moseq2_detectron_extract_tpu_torch.io.image import read_image
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.ops.preprocess import compute_test_scale
from moseq2_detectron_extract_tpu_torch.utils.profiling import count, span

FIELDS = ('image', 'masks', 'keypoints', 'valid')


def resize_linear(image: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    '''cv2's INTER_LINEAR resize of a (H, W) float32 image to (new_h, new_w).'''
    if image.shape == (new_h, new_w):
        return image.astype(np.float32, copy=True)
    x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32))[None, None]
    return F.interpolate(x, size=(new_h, new_w), mode='bilinear', align_corners=False,
                         antialias=False)[0, 0].numpy()


def load_sample(item: DataItem, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    '''Read and canvas-resize one annotated sample: image (S, S) float32,
    masks (G, S, S) bool, keypoints (G, K, 3), valid (G,).'''
    s = cfg.image_size
    g = cfg.max_gt_instances
    k = cfg.num_keypoints

    image = read_image(item['file_name'])
    image = np.atleast_3d(np.asarray(image))[:, :, 0].astype('float32')
    rescale = item.get('rescale_intensity') or 1.0
    if rescale != 1.0:
        image = image * rescale

    h, w = image.shape
    scale = compute_test_scale(h, w, cfg.min_size_train, cfg.max_size_train)
    new_h, new_w = min(int(h * scale + 0.5), s), min(int(w * scale + 0.5), s)

    canvas = np.zeros((s, s), dtype='float32')
    canvas[:new_h, :new_w] = resize_linear(image, new_h, new_w)

    masks = np.zeros((g, s, s), dtype=bool)
    keypoints = np.zeros((g, k, 3), dtype='float32')
    valid = np.zeros((g,), dtype=bool)
    for gi, annot in enumerate(item['annotations'][:g]):
        seg = annot['segmentation']
        if isinstance(seg, np.ndarray):
            mask_full = seg.astype(bool)
        else:
            poly = np.reshape(np.asarray(seg[0], dtype=float), (-1, 2))
            mask_full = poly_to_mask(poly, (h, w))[..., 0].astype(bool)
        ys = np.clip((np.arange(new_h) / scale).astype(int), 0, h - 1)
        xs = np.clip((np.arange(new_w) / scale).astype(int), 0, w - 1)
        masks[gi, :new_h, :new_w] = mask_full[np.ix_(ys, xs)]
        valid[gi] = masks[gi].any()

        kp = np.asarray(annot.get('keypoints', []), dtype='float32').reshape(-1, 3)
        if kp.shape[0] == k:
            keypoints[gi, :, 0] = kp[:, 0] * scale
            keypoints[gi, :, 1] = kp[:, 1] * scale
            keypoints[gi, :, 2] = kp[:, 2]
    return {'image': canvas, 'masks': masks, 'keypoints': keypoints, 'valid': valid}


class TrainLoader:
    '''Endless batches of samples drawn with replacement from
    ``np.random.default_rng(seed)``, made by one prefetch thread (each
    sample loaded once, then cached). Each batch is the host span
    ``loader.batch``; each sample read (a cache miss) adds one to the
    counter ``loader.samples_read``.'''

    def __init__(self, items: Sequence[DataItem], cfg: ModelConfig,
                 batch_size: Optional[int] = None, seed: int = 0, prefetch: int = 4):
        if not items:
            raise ValueError('empty training dataset')
        self.items = list(items)
        self.cfg = cfg
        self.batch_size = batch_size or cfg.ims_per_batch
        self.rng = np.random.default_rng(seed)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._cache: Dict[str, Dict[str, np.ndarray]] = {}
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _sample_batch(self) -> Dict[str, np.ndarray]:
        with span('loader.batch', device=False):
            idxs = self.rng.integers(0, len(self.items), self.batch_size)
            samples = []
            for i in idxs:
                item = self.items[int(i)]
                key = str(item['image_id'])
                if key not in self._cache:
                    self._cache[key] = load_sample(item, self.cfg)
                    count('loader.samples_read')
                samples.append(self._cache[key])
            return {field: np.stack([s[field] for s in samples]) for field in FIELDS}

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self._sample_batch()
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.25)
                        break
                    except queue_mod.Full:
                        continue
        except Exception as exc:  # noqa: BLE001 - handed to the consumer
            self._error = exc
            self._queue.put(None)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._queue.get()
        if batch is None:
            raise RuntimeError('the training loader failed') from self._error
        return batch

    def close(self):
        '''Stop the prefetch thread and wait for it.'''
        self._stop.set()
        self._thread.join(timeout=10)


def eval_batches(items: Sequence[DataItem], cfg: ModelConfig,
                 batch_size: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
    '''Batches over a dataset in order; the last padded with its last sample
    (``n_true`` counts the real ones).'''
    batch_size = batch_size or cfg.ims_per_batch
    out = []
    for start in range(0, len(items), batch_size):
        chunk = [load_sample(it, cfg) for it in items[start:start + batch_size]]
        n_true = len(chunk)
        while len(chunk) < batch_size:
            chunk.append(chunk[-1])
        batch = {field: np.stack([s[field] for s in chunk]) for field in FIELDS}
        batch['n_true'] = n_true
        out.append(batch)
    return out
