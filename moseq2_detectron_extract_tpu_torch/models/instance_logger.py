'''The per-frame instance log, ``instance_log.tsv``.

Port of ``moseq2_detectron_extract_tpu/models/instance_logger.py`` (lines
13-54), text for text: a header, then per frame its number of kept
detections and their scores; a frame with several also gets one row per
pair with their mask IoU, centre distance and mean keypoint distance.
'''
from typing import Optional

import numpy as np


class InstanceLogger:
    '''Streams per-frame instance metrics into a TSV.'''

    HEADER = ('frame\tnum_instances\tscores\tpair\tmask_iou\tcenter_dist'
              '\tmean_kpt_dist\n')

    def __init__(self, path: str):
        self.path = path
        with open(self.path, 'w', encoding='utf-8') as fh:
            fh.write(self.HEADER)
        # a large buffer: the per-frame writes do not reach the file system
        self._fh = open(self.path, 'a', encoding='utf-8', buffering=1 << 20)

    def log_frame(self, frame_idx: int, kept_idx, scores,
                  mask_iou: Optional[np.ndarray] = None,
                  centers: Optional[np.ndarray] = None,
                  keypoints: Optional[np.ndarray] = None) -> None:
        '''Log one frame; the pair rows only where several detections were
        kept.'''
        kept_idx = list(kept_idx)
        score_str = ','.join(f'{scores[j]:.3f}' for j in kept_idx)
        if len(kept_idx) < 2:
            self._fh.write(f'{frame_idx}\t{len(kept_idx)}\t{score_str}\t\t\t\t\n')
            return
        for a in range(len(kept_idx)):
            for b in range(a + 1, len(kept_idx)):
                i, j = kept_idx[a], kept_idx[b]
                iou = f'{mask_iou[i, j]:.4f}' if mask_iou is not None else ''
                cdist = ''
                if centers is not None and np.isfinite(centers[[i, j]]).all():
                    cdist = f'{np.linalg.norm(centers[i] - centers[j]):.2f}'
                kdist = ''
                if keypoints is not None:
                    diff = keypoints[i, :, :2] - keypoints[j, :, :2]
                    if np.isfinite(diff).all():
                        kdist = f'{np.linalg.norm(diff, axis=1).mean():.2f}'
                self._fh.write(f'{frame_idx}\t{len(kept_idx)}\t{score_str}'
                               f'\t{i}-{j}\t{iou}\t{cdist}\t{kdist}\n')

    def close(self) -> None:
        '''Flush and close the TSV.'''
        self._fh.close()
