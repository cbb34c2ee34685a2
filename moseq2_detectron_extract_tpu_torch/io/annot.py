'''Label Studio annotations and the dataset registry, without cv2 or tqdm.

Port of the part of ``moseq2_detectron_extract_tpu/io/annot.py`` that
``load_annotations_helper`` (lines 304-333) reaches: the Label Studio
parsing (lines 137-300), its types (``MaskFormat``, ``SegmAnnotation``,
``KptSegmAnnotation`` and ``DataItem``, 25-48), the registry and ``split_test_train``,
``validate_annotations``, the path replacement and the dataset statistics.

cv2 is replaced where the reference calls it:

* :func:`poly_to_mask` is ``cv2.fillPoly`` (8-connected, shift 0) on the
  rounded points: the outline is drawn with cv2's Bresenham walk, then
  the scanlines between the edges are filled in cv2's 16.16 fixed point
  (from the left edge rounded up to the right edge rounded down), so the
  outline pixels are inside the mask too; an edge that leaves the image is
  drawn and followed along its ``clipLine`` segment, as cv2 5.0 does;
* :func:`point_in_polygon` is ``cv2.pointPolygonTest(..., False) >= 0`` on
  float32 points (a point on an edge is inside);
* :func:`mask_to_poly` is ``cv2.findContours(mask, RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)``: Suzuki and Abe's border following of the outer
  borders on the mask framed by one row and column of zeros, with cv2's
  raster scan, its start pixel and search directions, its marking of the
  followed pixels, its rule for skipping components inside another one's
  hole, one point where the chain code changes direction, and its order
  (the last contour found first).

``get_polygon_data`` scales a polygon's x by the image's height and its y
by its width, as the reference does (a fault of the reference, kept so
that both packages read an export the same way). ``split_test_train``
shuffles with the stdlib ``random``, so a seeded split matches.
'''
import json
import logging
import os
import pathlib
import random
import re
from typing import (Callable, Dict, List, Literal, MutableSequence, Optional, Sequence, Tuple,
                    TypedDict, Union)

import numpy as np

from moseq2_detectron_extract_tpu_torch.io.image import read_image
from moseq2_detectron_extract_tpu_torch.proc.keypoints import (default_keypoint_colors,
                                                               default_keypoint_connection_rules,
                                                               default_keypoint_names)

MaskFormat = Literal['polygon', 'bitmask']


class SegmAnnotation(TypedDict):
    '''Segmentation annotation for one instance.'''
    bbox: Sequence[float]
    bbox_mode: str
    category_id: int
    segmentation: Union[Sequence[Sequence[float]], np.ndarray]


class KptSegmAnnotation(SegmAnnotation):
    '''Segmentation + keypoints annotation.'''
    keypoints: Sequence[float]


class DataItem(TypedDict):
    '''One training sample.'''
    file_name: str
    width: int
    height: int
    image_id: str
    rescale_intensity: float
    annotations: Sequence[KptSegmAnnotation]


# -- the dataset registry ------------------------------------------------------------

_DATASETS: Dict[str, Callable[[], MutableSequence[DataItem]]] = {}
_METADATA: Dict[str, dict] = {}


def dataset_catalog_get(name: str) -> MutableSequence[DataItem]:
    '''Resolve a registered dataset by name.'''
    return _DATASETS[name]()


def metadata_catalog_get(name: str) -> dict:
    '''Metadata dict for a registered dataset (registers the defaults).'''
    if name not in _METADATA:
        register_dataset_metadata(name)
    return _METADATA[name]


def dataset_is_registered(name: str) -> bool:
    '''True if a dataset name is registered.'''
    return name in _DATASETS or name in _METADATA


def register_dataset_metadata(name: str) -> None:
    '''Register the default mouse metadata.'''
    _METADATA[name] = {
        'thing_classes': ['mouse'],
        'thing_colors': [(0, 0, 255)],
        'keypoint_names': default_keypoint_names,
        'keypoint_flip_map': [],
        'keypoint_connection_rules': default_keypoint_connection_rules,
        'keypoint_colors': default_keypoint_colors,
    }


def split_test_train(annotations: MutableSequence[DataItem], split: float = 0.90):
    '''Shuffle (stdlib ``random``) and split into train/test accessors.'''
    random.shuffle(annotations)
    split_idx = int(len(annotations) * split)
    return (lambda: annotations[:split_idx], lambda: annotations[split_idx:])


def register_datasets(annotations: MutableSequence[DataItem], split: bool = True) -> None:
    '''Register annotations as moseq_train / moseq_test.'''
    if split:
        train_fn, test_fn = split_test_train(annotations)
        for name, fn in [('moseq_train', train_fn), ('moseq_test', test_fn)]:
            _DATASETS[name] = fn
            register_dataset_metadata(name)
    else:
        _DATASETS['moseq_train'] = lambda: annotations
        register_dataset_metadata('moseq_train')


# -- geometry: cv2.fillPoly and cv2.pointPolygonTest -----------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _set(mask: np.ndarray, x: int, y: int) -> None:
    if 0 <= y < mask.shape[0] and 0 <= x < mask.shape[1]:
        mask[y, x] = 1


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    '''cv2's ``clipLine``: the segment's end points moved onto the image's
    edges (integer arithmetic, quotients truncated), or None outside.'''
    right, bottom = width - 1, height - 1

    def code(x, y, with_y=True):
        return (x < 0) + (x > right) * 2 + ((y < 0) * 4 + (y > bottom) * 8 if with_y else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def _line8(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    '''cv2's 8-connected line (``LineIterator`` walked left to right, its
    end points clipped into the image first).'''
    height, width = mask.shape[:2]
    if not (0 <= x0 < width and 0 <= y0 < height and 0 <= x1 < width and 0 <= y1 < height):
        clipped = _clip_line(width, height, x0, y0, x1, y1)
        if clipped is None:
            return
        x0, y0, x1, y1 = clipped
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        _set(mask, x, y)
        diag = err < 0
        err += minus + (plus if diag else 0)
        if steep:
            y += sy
            x += 1 if diag else 0
        else:
            x += 1
            y += sy if diag else 0


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_poly(mask: np.ndarray, points: np.ndarray, value: int = 1) -> np.ndarray:
    '''``cv2.fillPoly(mask, [points], value)`` for one polygon of integer
    (n, 2 [x, y]) points, 8-connected, in place.'''
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    height, width = mask.shape[:2]
    outline = np.zeros(mask.shape[:2], np.uint8)
    edges = []                                   # (y0, y1, x at y0, dx), 16.16 fixed
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        _line8(outline, x0, y0, x1, y1)
        # an edge that leaves the image runs along its clipped segment: the
        # clipped end points (their x alone when the clipped segment is
        # level), over the edge's own rows
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= x0 < width and 0 <= y0 < height and 0 <= x1 < width and 0 <= y1 < height):
            clipped = _clip_line(width, height, x0, y0, x1, y1)
            if clipped is not None:
                c0x, c1x = clipped[0], clipped[2]
                if clipped[1] != clipped[3]:
                    c0y, c1y = clipped[1], clipped[3]
        if y0 != y1:
            dx = _trunc_div((c1x - c0x) << _XY_SHIFT, c1y - c0y)
            if y0 < y1:
                edges.append((y0, y1, (c0x << _XY_SHIFT) + (y0 - c0y) * dx, dx))
            else:
                edges.append((y1, y0, (c1x << _XY_SHIFT) + (y1 - c1y) * dx, dx))
        x0, y0 = x1, y1
    if len(edges) >= 2:
        y_lo = min(e[0] for e in edges)
        y_hi = min(max(e[1] for e in edges), height)
        for y in range(max(y_lo, 0), y_hi):
            xs = sorted(fx + (y - ey0) * dx for ey0, ey1, fx, dx in edges
                        if ey0 <= y < ey1)
            for left, right in zip(xs[0::2], xs[1::2]):
                xa, xb = (left + _XY_ONE - 1) >> _XY_SHIFT, right >> _XY_SHIFT
                if xa < width and xb >= 0:
                    outline[y, max(xa, 0):min(xb, width - 1) + 1] = 1
    mask[outline.astype(bool)] = value
    return mask


def poly_to_mask(poly: np.ndarray, out_shape: Tuple[int, int]) -> np.ndarray:
    '''Rasterize an (n, 2 [x, y]) polygon into a (H, W, 1) uint8 mask.'''
    mask = np.zeros(out_shape, dtype=np.uint8)
    pts = np.round(np.asarray(poly)).astype(np.int64)
    return fill_poly(mask, pts, 1)[..., None]


# chain-code directions (dx, dy): east, then counterclockwise on the screen
_CHAIN = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
_RIGHT_BOUND = -126          # cv2's ``nbd | -128`` as a signed char, nbd 2
_BORDER = 2


def _follow_outer_border(img: np.ndarray, y0: int, x0: int) -> List[Tuple[int, int]]:
    '''Follow the outer border that starts at (y0, x0) of the framed int
    image, marking its pixels as cv2 does, and return its points (x, y) of
    the unframed mask, one at each change of direction.'''
    s = s_end = 4
    while True:                         # clockwise from north-west for a neighbour
        s = (s - 1) & 7
        y1, x1 = y0 + _CHAIN[s][1], x0 + _CHAIN[s][0]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end:                      # a single pixel
        img[y0, x0] = _RIGHT_BOUND
        return [(x0 - 1, y0 - 1)]
    points = []
    y3, x3 = y0, x0
    prev_s = s ^ 4
    px, py = x0 - 1, y0 - 1
    while True:
        s_end = s
        while s < 15:                   # counterclockwise from the previous pixel
            s += 1
            y4, x4 = y3 + _CHAIN[s & 7][1], x3 + _CHAIN[s & 7][0]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:             # the east neighbour was examined and is 0
            img[y3, x3] = _RIGHT_BOUND
        elif img[y3, x3] == 1:
            img[y3, x3] = _BORDER
        if s != prev_s:
            points.append((px, py))
            prev_s = s
        px, py = px + _CHAIN[s][0], py + _CHAIN[s][1]
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            return points
        y3, x3 = y4, x4
        s = (s + 4) & 7


def mask_to_poly(mask: np.ndarray) -> List[np.ndarray]:
    '''Outer boundary polygons of a binary mask, each an (n, 1, 2) int32
    array of (x, y) points, as ``cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_SIMPLE)`` gives them.'''
    mask = np.asarray(mask)
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int16)
    img[1:-1, 1:-1] = mask != 0
    contours = []
    lnbd = (1, 0)                       # the last labelled pixel met by the scan
    for y in range(1, h + 1):
        row = img[y]
        x, prev = 1, 0
        while x <= w:
            changed = np.flatnonzero(row[x:w + 1] != prev)
            if not changed.size:
                break
            x += int(changed[0])
            p = int(row[x])
            if prev == 0 and p == 1:            # an outer border starts here
                if img[lnbd] <= 0:              # not inside another component
                    contours.append(_follow_outer_border(img, y, x))
                    prev = int(row[x])
                    x += 1
                    continue
            elif p == 0 and prev == _BORDER:
                lnbd = (y, x - 1)               # a hole starts (not followed)
            prev = p
            if p not in (0, 1):
                lnbd = (y, x)
            x += 1
        lnbd = (y + 1, 0)
    return [np.asarray(c, np.int32).reshape(-1, 1, 2) for c in reversed(contours)]


def point_in_polygon(point: Tuple[float, float], poly: np.ndarray) -> bool:
    '''``cv2.pointPolygonTest(poly, point, False) >= 0``: inside or on an
    edge, on float32 coordinates.'''
    f32 = np.float32
    pts = np.asarray(poly, np.float32).reshape(-1, 2)
    px, py = f32(point[0]), f32(point[1])
    vx, vy = pts[-1]
    counter = 0
    for x, y in pts:
        v0x, v0y, vx, vy = vx, vy, x, y
        if (v0y <= py and vy <= py) or (v0y > py and vy > py) or (v0x < px and vx < px):
            if py == vy and (px == vx or (py == v0y and ((v0x <= px <= vx) or
                                                         (vx <= px <= v0x)))):
                return True
            continue
        dist = float(f32(py - v0y)) * float(f32(vx - v0x)) - \
            float(f32(px - v0x)) * float(f32(vy - v0y))
        if dist == 0:
            return True
        if vy < v0y:
            dist = -dist
        counter += dist > 0
    return counter % 2 == 1


# -- Label Studio parsing ----------------------------------------------------------------

def get_image_path(entry: dict) -> str:
    '''The image path of a task entry, the upload hash prefix stripped.'''
    if 'task_path' in entry:
        path = entry['task_path']
    elif 'data' in entry and 'image' in entry['data']:
        path = entry['data']['image']
    elif 'data' in entry and 'depth_image' in entry['data']:
        path = entry['data']['depth_image']
    else:
        raise KeyError('Could not locate image path from entry!')
    p = pathlib.Path(path)
    p = p.with_name(re.sub(r'(\w+-)', '', p.name))
    return str(p)


def get_polygon_data(entry: dict, mask_format: str) -> dict:
    '''A polygon result (percent coordinates) -> a pixel-space annotation
    (x scaled by the height and y by the width, as the reference does).'''
    poly = np.array(entry['value']['points'], dtype=float)
    poly[:, 1] = (poly[:, 1] * entry['original_width']) / 100
    poly[:, 0] = (poly[:, 0] * entry['original_height']) / 100

    if mask_format == 'polygon':
        seg = np.empty((poly.size,), dtype=poly.dtype)
        seg[0::2] = poly[:, 0]
        seg[1::2] = poly[:, 1]
        segmentation = [list(seg)]
    elif mask_format == 'bitmask':
        segmentation = poly_to_mask(poly, (entry['original_height'],
                                           entry['original_width']))[..., 0]
    else:
        raise RuntimeError(f"Got unsupported mask_format '{mask_format}'")
    return {
        'category_id': 0,
        'bbox_mode': 'XYXY_ABS',
        'segmentation': segmentation,
        'bbox': [float(np.min(poly[:, 0])), float(np.min(poly[:, 1])),
                 float(np.max(poly[:, 0])), float(np.max(poly[:, 1]))],
    }


def get_keypoint_data(entry: dict) -> Dict[str, dict]:
    '''A keypoint result (percent coordinates) -> {name: {x, y, v}}.'''
    return {
        entry['value']['keypointlabels'][0]: {
            'x': (entry['value']['x'] * entry['original_width']) / 100,
            'y': (entry['value']['y'] * entry['original_height']) / 100,
            'v': 2,
        }
    }


def sort_keypoints(keypoint_order: List[str], keypoints: dict) -> List[float]:
    '''[x, y, v, ...] in ``keypoint_order``; a missing keypoint is (0, 0, 0).'''
    out: List[float] = []
    for kp in keypoint_order:
        if kp in keypoints:
            k = keypoints[kp]
            out.extend([k['x'], k['y'], k['v']])
        else:
            out.extend([0, 0, 0])
    return out


def get_results_of_type(results: List[dict], annot_type: str) -> List[dict]:
    '''The result entries of one annotation type.'''
    return [r for r in results if r['type'] == annot_type]


def find_best_poly_overlap(polys: List[dict], point: dict) -> dict:
    '''The polygon that holds the keypoint, else the one nearest to it.'''
    scores = []
    test_point = (point['x'], point['y'])
    for p in polys:
        coords = np.reshape(p['segmentation'][0], (-1, 2))
        if point_in_polygon(test_point, coords):
            return p
        dists = np.sqrt(np.sum((coords - np.asarray(test_point)) ** 2, axis=1))
        scores.append(np.min(dists))
    return polys[int(np.argmin(scores))]


def get_annotation_from_entry(entry: dict, key: str = 'annotations',
                              mask_format: str = 'polygon',
                              keypoint_names: Optional[List[str]] = None) -> DataItem:
    '''Parse one Label Studio task entry.'''
    if len(entry[key]) > 1:
        logging.warning('WARNING: Task %s: Multiple annotations found, only '
                        'taking the first', entry['id'])
    original_width = original_height = None
    for rslt in entry[key][0]['result']:
        if 'original_width' in rslt and 'original_height' in rslt:
            original_width = rslt['original_width']
            original_height = rslt['original_height']
            break

    poly_results = get_results_of_type(entry[key][0]['result'], 'polygonlabels')
    instances = [get_polygon_data(r, mask_format=mask_format) for r in poly_results]
    for instance in instances:
        instance['keypoints'] = {}

    for kpt in get_results_of_type(entry[key][0]['result'], 'keypointlabels'):
        kdata = get_keypoint_data(kpt)
        kname = list(kdata.keys())[0]
        owner = find_best_poly_overlap(instances, kdata[kname])
        if kname in owner['keypoints']:
            logging.warning('WARNING: Task %s: Keypoint "%s" has already been '
                            'parsed, replacing value', entry['id'], kname)
        owner['keypoints'].update(kdata)

    if keypoint_names is not None:
        for instance in instances:
            instance['keypoints'] = sort_keypoints(keypoint_names, instance['keypoints'])

    if original_width is None or original_height is None:
        raise ValueError(f'Task {entry.get("id")}: no result carries the image size')
    return {
        'file_name': get_image_path(entry),
        'width': original_width,
        'height': original_height,
        'image_id': entry['id'],
        'annotations': instances,
        'rescale_intensity': 1,
    }


def read_annotations(annot_file: str, keypoint_names: Optional[List[str]] = None,
                     mask_format: str = 'polygon', rescale: float = 1.0) -> List[DataItem]:
    '''Read a Label Studio annotation export (JSON).'''
    if keypoint_names is None:
        logging.warning('WARNING: Ignoring any keypoint information because '
                        '`keypoint_names` is None.')
    with open(annot_file, 'r', encoding='utf-8') as in_file:
        data = json.load(in_file)
    out = []
    for entry in data:
        key = 'annotations' if 'annotations' in entry else \
            ('completions' if 'completions' in entry else None)
        if key is None:
            raise ValueError('Cannot find annotation data for entry!')
        item = get_annotation_from_entry(entry, key=key, mask_format=mask_format,
                                         keypoint_names=keypoint_names)
        item['rescale_intensity'] = rescale
        out.append(item)
    return out


def read_tasks(tasks_file: str, rescale: float = 1.0) -> List[DataItem]:
    '''Read task entries without annotations (``m2de/io/annot.py:330-349``).'''
    with open(tasks_file, 'r', encoding='utf-8') as in_file:
        data = json.load(in_file)
    tasks = []
    for entry in data:
        image_path = get_image_path(entry)
        image = read_image(image_path)
        tasks.append({'file_name': image_path, 'width': image.shape[1],
                      'height': image.shape[0], 'image_id': image_path,
                      'rescale_intensity': rescale, 'annotations': []})
    return tasks


def load_annotations_helper(annot_files, image_format: str,
                            replace_paths: Optional[Sequence[Tuple[str, str]]] = None,
                            mask_format: str = 'polygon', register: bool = True,
                            show_info: bool = True) -> List[DataItem]:
    '''Load the exports, fix paths, validate, and optionally register the
    train/test split and log the dataset's statistics.'''
    logging.info('Loading annotations....')
    annotations: List[DataItem] = []
    for annot_f in annot_files:
        logging.info('Reading annotation file "%s"', annot_f)
        annot = read_annotations(annot_f, default_keypoint_names, mask_format=mask_format)
        logging.info(' -> Found %d annotations', len(annot))
        annotations.extend(annot)
    if replace_paths is not None:
        annotations = replace_multiple_data_paths_in_annotations(annotations, replace_paths)
    validate_annotations(annotations)
    if show_info:
        logging.info('Dataset information:')
        show_dataset_info(annotations, image_format)
    if register:
        register_datasets(annotations)
    return annotations


# -- dataset statistics ---------------------------------------------------------------

def get_dataset_statistics(dset: Sequence[DataItem], image_format: str):
    '''Mean and standard deviation per channel, averaged over the images.'''
    nchannels = 1 if image_format == 'L' else 3
    count = 0
    mean = np.zeros((nchannels,), dtype=float)
    stdev = np.zeros((nchannels,), dtype=float)
    for d in dset:
        image = np.atleast_3d(read_image(d['file_name']))
        if image.shape[2] == 1:
            image = np.repeat(image, nchannels, axis=2)
        count += 1
        for c in range(nchannels):
            mean[c] += image[:, :, c].mean()
            stdev[c] += image[:, :, c].std()
    return mean / max(count, 1), stdev / max(count, 1)


def get_dataset_im_size_range(dset: Sequence[DataItem]):
    '''((min_w, max_w), (min_h, max_h)) over a dataset.'''
    widths = [d['width'] for d in dset]
    heights = [d['height'] for d in dset]
    return ((np.min(widths), np.max(widths)), (np.min(heights), np.max(heights)))


def get_dataset_bbox_aspect_ratios(dset: Sequence[DataItem]) -> dict:
    '''Statistics of the first instance's box aspect ratio.'''
    ratios = []
    for d in dset:
        box = d['annotations'][0]['bbox']
        ax1, ax2 = box[2] - box[0], box[3] - box[1]
        ratios.append(max(ax1, ax2) / max(min(ax1, ax2), 1e-9))
    return {'min': float(np.min(ratios)), 'max': float(np.max(ratios)),
            'mean': float(np.mean(ratios)), 'median': float(np.median(ratios)),
            'stdev': float(np.std(ratios))}


def get_dataset_bbox_range(dset: Sequence[DataItem]) -> dict:
    '''Statistics of the first instance's box width and height.'''
    widths, heights = [], []
    for d in dset:
        box = d['annotations'][0]['bbox']
        widths.append(box[2] - box[0])
        heights.append(box[3] - box[1])

    def stats(vals):
        return {'min': np.min(vals), 'max': np.max(vals), 'mean': np.mean(vals),
                'median': np.median(vals), 'stdev': np.std(vals)}
    return {'width': stats(widths), 'height': stats(heights)}


def show_dataset_info(annotations: Sequence[DataItem], image_format: str) -> None:
    '''Log a dataset summary.'''
    logging.info('Number of Items: %d', len(annotations))
    sizes = get_dataset_im_size_range(annotations)
    logging.info('Image size range:')
    logging.info(' -> Width: %s - %s px', sizes[0][0], sizes[0][1])
    logging.info(' -> Height: %s - %s px', sizes[1][0], sizes[1][1])
    bbox_sizes = get_dataset_bbox_range(annotations)
    bbox_ratios = get_dataset_bbox_aspect_ratios(annotations)
    logging.info('Instance Bounding Box Sizes:')
    logging.info(' -> Width: %.2f - %.2f; mean %.2f +/- %.2f stdev',
                 bbox_sizes['width']['min'], bbox_sizes['width']['max'],
                 bbox_sizes['width']['mean'], bbox_sizes['width']['stdev'])
    logging.info(' -> Height: %.2f - %.2f; mean %.2f +/- %.2f stdev',
                 bbox_sizes['height']['min'], bbox_sizes['height']['max'],
                 bbox_sizes['height']['mean'], bbox_sizes['height']['stdev'])
    logging.info(' -> Ratio: %.2f - %.2f; mean %.2f +/- %.2f stdev',
                 bbox_ratios['min'], bbox_ratios['max'], bbox_ratios['mean'],
                 bbox_ratios['stdev'])
    means, stdevs = get_dataset_statistics(annotations, image_format=image_format)
    logging.info('Pixel Intensity Statistics:')
    for channel in range(means.shape[0]):
        logging.info(' -> Ch%d: mean %.2f +/- %.2f stdev', channel, means[channel],
                     stdevs[channel])


def replace_multiple_data_paths_in_annotations(annotations: List[DataItem],
                                               replace_paths) -> List[DataItem]:
    '''Apply search/replace pairs to the annotations' file paths in turn.'''
    for search, replace in replace_paths:
        annotations = replace_data_path_in_annotations(annotations, search, replace)
    return annotations


def replace_data_path_in_annotations(annotations: List[DataItem], search: str,
                                     replace: str) -> List[DataItem]:
    '''Substring replacement in the annotations' file paths.'''
    for annot in annotations:
        annot['file_name'] = annot['file_name'].replace(search, replace)
    return annotations


def validate_annotations(annotations: Sequence[DataItem]) -> bool:
    '''Raise ``FileNotFoundError`` unless every annotation's image exists.'''
    for annot in annotations:
        if not os.path.isfile(annot['file_name']):
            raise FileNotFoundError(annot['file_name'])
    return True
