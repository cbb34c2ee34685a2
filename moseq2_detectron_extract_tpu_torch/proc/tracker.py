'''Greedy nearest-centroid instance tracker (host, numpy).

The port's own copy of ``moseq2_detectron_extract_tpu/proc/tracker.py``
(the norfair stand-in: euclidean distance threshold, hit counters), used by
the instance-selection loop to prefer the longest-tracked instances when a
frame holds several detections. Object ids come from a counter owned by
each tracker.
'''
import itertools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class TrackedObject:
    '''One tracked instance.'''
    center: np.ndarray
    object_id: int
    age: int = 0
    hit_counter: int = 1
    last_detection_index: Optional[int] = None
    live: bool = True


class CentroidTracker:
    '''Greedy nearest-centroid tracker with age and hit counters.'''

    def __init__(self, distance_threshold: float = 50.0, hit_counter_max: int = 3):
        self.distance_threshold = distance_threshold
        self.hit_counter_max = hit_counter_max
        self.objects: List[TrackedObject] = []
        self._ids = itertools.count()

    def update(self, centers: np.ndarray, valid: Optional[np.ndarray] = None
               ) -> List[TrackedObject]:
        '''Advance one frame with detections at ``centers`` (D, 2); returns
        the objects seen in this frame, each holding its detection index.'''
        centers = np.asarray(centers, dtype=float)
        if valid is None:
            valid = np.ones(len(centers), bool)
        det_idx = [i for i in range(len(centers)) if valid[i] and
                   np.isfinite(centers[i]).all()]

        for obj in self.objects:
            obj.age += 1
            obj.live = False
            obj.last_detection_index = None

        pairs: List[Tuple[float, int, int]] = []
        for oi, obj in enumerate(self.objects):
            for di in det_idx:
                dist = float(np.linalg.norm(obj.center - centers[di]))
                if dist < self.distance_threshold:
                    pairs.append((dist, oi, di))
        pairs.sort()
        used_obj, used_det = set(), set()
        for _, oi, di in pairs:
            if oi in used_obj or di in used_det:
                continue
            used_obj.add(oi)
            used_det.add(di)
            obj = self.objects[oi]
            obj.center = centers[di]
            obj.hit_counter = min(obj.hit_counter + 1, self.hit_counter_max)
            obj.live = True
            obj.last_detection_index = di

        for oi, obj in enumerate(self.objects):
            if oi not in used_obj:
                obj.hit_counter -= 1
        self.objects = [o for o in self.objects if o.hit_counter > 0]
        for di in det_idx:
            if di not in used_det:
                self.objects.append(TrackedObject(
                    center=centers[di], object_id=next(self._ids), live=True,
                    last_detection_index=di))
        return [o for o in self.objects if o.live]
