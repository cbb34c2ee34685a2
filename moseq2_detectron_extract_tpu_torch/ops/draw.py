'''The preview's drawing, as OpenCV 5.0 draws it: anti-aliased lines, filled
anti-aliased circles of radius 2, rectangles, the ROI outline, the frame
number and box index text, the linear resize and the mask blend.

The JAX package draws its preview with cv2 (``viz.py``, ``io/video.py``);
the card's machine has no cv2. Each primitive here has two versions: the
plain one, in Python and numpy (``line_aa``, ``circle_aa``, ``rectangle``,
``draw_contours_aa``, ``put_text``, ``put_number``, ``resize_linear``,
``blend_mask``),
and the C++ core ``csrc/draw_host.cpp``, built with g++ by
``native.build_host_library`` at its first call, which draws a whole block
of frames from a list of records in one call (``DrawList``,
``resize_linear_block``, ``blend_windows``). The tests hold the C++ to the
plain versions exactly, and both to cv2 5.0.

* ``line_aa`` is OpenCV's ``LineAA``: end points in 16-bit fixed point, a
  3-pixel footprint weighted by its filter table (``FILTER``), corrected at
  the ends and by the slope (``SLOPE``), each tap blended twice as
  ``v += ((c - v) * a + 127) >> 8``.
* ``circle_aa``: ``cv2.circle(..., r, -1, LINE_AA)`` for r < 3 is
  ``FillConvexPoly`` with anti-aliased edges of the 4-point diamond that
  ``ellipse2Poly`` gives at its 90-degree step.
* ``put_text`` and ``put_number``: OpenCV 5.0 draws ``FONT_HERSHEY_SIMPLEX``
  through its TrueType renderer, not as Hershey strokes, so the glyphs are
  kept as the coverage (0-255) of each one as cv2 5.0 draws it at the
  three sizes the port uses (``GLYPH_SIZES``: scale 1 thickness 2, the
  frame number; scale 0.4 thickness 1, the box index; scale 0.35
  thickness 1, the score of ``viz.draw_instances``, with the decimal
  point). A glyph is placed at whole pixels, each ``advance`` after the
  last (the point's own is narrower), and blended as ``(v * (255 - a) + c
  * a + 127) // 255``, so overlapping glyphs blend one after the other.
  The score's size is drawn in ``LINE_8``, where the others are
  ``LINE_AA``: cv2 5.0's renderer gives the same coverage for both.
* ``resize_linear`` is ``cv2.resize(INTER_LINEAR)`` on uint8: 11-bit
  weights, the x taps clamped at the borders and the y rows only, the
  vertical sum rounded as OpenCV's vector code rounds it.
'''
import base64
import ctypes
import functools
import zlib
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from moseq2_detectron_extract_tpu_torch import native

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
SLOPE = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
         203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254)
FILTER = (168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
          254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
          158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
          40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5)

# glyphs of cv2 5.0's putText(FONT_HERSHEY_SIMPLEX): per size, one
# (gh, gw) uint8 coverage cell for each of ``chars`` (the digits where a
# size names none), zlib then base64; ``top``/``left`` place the cell
# against the text origin (its baseline's left end), ``advance`` is the step
# to the next glyph (``advances`` overrides it for a character)
_STAMP = (
    'eNrNl3lQ1VUUx+97IJuCAqIJsoi4DxCEQKlDY+q4IFI6YOFSablM4iSaFhhmbrhUY8uMGmJmgBlRmtYoLaYyuAxu'
    'uWJgIuoguaEC8t77db/3/pbzA7X+7Pxzz/v87u/+zj3nnnPPYwziEv7ivDHdrUwXv4IHCqQ+q41KkmoVTcp7CRJ0'
    'VzHksBPQ9+Lx1GEZgs3kpBeUqraMDROoiqPxUD7VZiuKH2PLMY5hLNh2cDXUEYwVYOyCR5PHqYsVY/RkbrXX3UZD'
    'nc3YDozubJKSw0ZBfVNHZbZuOirC2D5G2c63ATWdsc0YQzYqwxlLgzqNsUyMGfcruBs2QE1gLFFaOIcbe4mPDi/G'
    'ujQL5M2YsOEktr1WoPVZBeLZaCDvWuKcHdKFkcd0ssVHdatL9olG/vtWaTIj4tQjIYC1kH5xcdFWCtrlY6WJhPQ5'
    'pftdlfH1ihm5fKyZoCHnffjloMiKdf6aaHqxb73yg28P8/JDp1tYCwT5H6LllVyqgeq4crofR6WKScY+HG02kYZY'
    '9khpP2D64pQwiwG8PpRH5eaWtiqJqtFXOthJEI8zZPXzzkA5UP+cm5R7G0o80GmuXA/iykygTBwvO1c+wTN/oJ1c'
    '8cwrLMwLBHpG0R7qsgnoJUreBrniQ8gccQ6GGcBVpIGyyCABZQD2WQaJugrSOJaQOpCmxFZkdCsyxiBBMl/uV0o5'
    'zt2zwBwNhfs+uzWaaDeRO0EPj07HOCJRIkrmaE8COmVC6UAnTWgGUPJKKaJEXehMvtIbVeJCICGx1zmp6ErIUKTk'
    'eZreKU2cnKOkvw1LX85N7aijSZoJ9UM0lKib1TROY11DQ8OnfQ1WaXbAEbCuJvSaeig+Ky09MFeidWoh3oWjMBIk'
    '8D5X77ozNk2Evjgza58wbhvqxHbqm1pxVr2+dejkd21PcbtEeKt3zXMm3/eMHOjTOlJ9eYA6UuC8UyQMRe+J5c8Q'
    'kmBriXyrlRbI8h2sNKE3+K/SFRRFNPBD1H0JQR5Iv1cZRUiMIkZRCldrfCkKualmk46cceI+Yio66+rqxJ6HhRfP'
    'c/lbWnu7w1SlpYQ+BEUfOqoKUqnh6NGfPYytr2/hnP+M5nO0/dElzrW/kUOhEuURo5plNA9TQ2Uu1FAkDoUTj5dD'
    'zaOVGUyrZHXmD8ZoN6whuMD3MIt/ZFsdTedofyE/p/aKbHeJFpPvVQ0QKJfacO0JIOTJg2U9/ZOPaEWU+cbHxwsD'
    'vU5gRx6mb2dh2kBe6iMiItS0nwyUytjnKF699cPh8Ff7nBIY9Nwdrv2BE49kUs4tm78Nl748C+84iF2l8uSn3NNJ'
    'kbtWM3PLUSeqi9NpF+ASNaJLqzgF8fi0M5FUVMn3KQnD9VJDE80FgbMPppPWwILllIyCtWVtCAlAhbsdSruXX0Wd'
    'Kt84M8DkOVm+5smXwx+QbZeI7lHkOW+FbolxCS5xfK1xgpVZ0+AwO288Fxr3+gyoUxgrxCjrfiDUDRLZ28t72SbR'
    'FL03k53bOHX2mRBOgpHjzR24dkI0CfkL87EtZTemh54lph7wltVlv05+1A6J2+z8CofiOJs31YW6zGcg8bIfvYdi'
    'xZvlpsxeD3TBhLa2RgXiwi5W5RDQUlPA0bfYe1Li39QquZfiPVPAPVBNjpkmibo/mRILnHXVlaIRmLTQ9N5uZIQf'
    'JeEOGQkiSEpHP0o68fqr/GSaJG794aZCdI2TUxaKXsGk101mHkfb5E6RN//L0jiD/as490mdmxhE1o8uaxB+v1Gk'
    'xXK8kaKVEbIyiURurhFDvS/QF9DS3Jh3jkPtv6ywXNY7/FH5EkXBrkfhXa79pnUdq4QliO0KaKvgqrWDgkfuhfKs'
    'yNid5EjMYcbZllIXYrQXmlx5kpNu+KJt5dDeyd+IYmhVO8skMf8DqP0Zw+V+UfogTA3vL2hN5Xe6AS1W29UhxnHi'
    'Lw4WWbsg2m+QaCCvYI3V9PQ2ThBby7UZZj2t3f5bRadwbc8a2g+1C0/obI6QR8zLGUk9STcRViIbwXvaFcDSSYRE'
    'a8JGUiMuIZG9L0PdN/uFnJvibxlT60QBilTUDbRWPJfFfyajuCtRjJUgstI54oUUeZ+qHZZw4VPqo2yR91W4a9x4'
    'zcFdoKyJ6ZwkOstcPEwzOSdYLLGo2UDztStgv9bs7jXuAM9BmfD3Ddr4Wndr/190eQtkHSWxqMCn6Q3nhSLTEEkn'
    'fYXXZlHiyTdg32R5TPb8A75ZIXo=')
_INDEX = (
    'eNpjYFDwNWBkYCj9c/T/WWbpX54Mp36E+b5lNupbNSH+AsNs1e6FsReF1jH0LHT+VuPLsLuD78N/btcfjgwB/79/'
    'rmUAAiEmEMmgLQ4kmNv/VQCpHYePgCh71nUVYDksFAvbhmo2JoZX/4GgkwEGZH01gW6Je7fj7TImlg8+DJK/9ThT'
    'mBhYPtgCJRknXWYFkjPuywPJmQ8UQORTDTY2RlOQIf9LYIZY2AABB/PhY8fu/NUE8sVu5QJJvrMdIMmZv+d7Aikp'
    'g+QvbgJAIxjWdjl/UGdQfxfFUPX+zYcOZqCpIowQgwxkQGTc/wlAUunpRiDFcjSlF0jVbWAAUhaPRUHU/D/fvv3+'
    'd5OFk5NzyhQ2kI7uboSHgE6xYmKYe+/YsaP8DNtiwYLnI5x1gdTzp6vu7WBnMOdj4LqeIeUFFFnRovDHiUHnjRtD'
    '3LNXb0pBaoUhbuE0BVNLVoPI2MdCQFL50+Y4AQaGg/d7tj2RNfotCfTKZLcXQImGVbyf4hhlbqUwWF15/7IVZAAf'
    'iLAEhQsf+6kzZ8789QeZY/6RD0QtnQQiJX+ogaiGrSCS7bkHiIq5Abb9QAYDElD2NQQGUvvzZZf3cfL/lGNgueTD'
    '/tWKQeyxA0PJ75tftzPIvinRDn4WlHAcqLh1sfVHHQaBU+UMxW/vv57FAQpdcHpR9gMFQee7HS9WMRn/UGIQfhIR'
    'dQUosqFJ/YcZg/IbX4aUD7d/7Qfaz5LxTg4oIfosDBwCcxAuAQDjj84V')
_SCORE = (
    'eNpjiNx3IoxB95HJhv8KudOYZy2Oq6n28+/ILemYxTwtzfVzHectc8aLP55OZGBgYGcDEsy1FQwM3DsPr2BgYHH0BJ'
    'IMDOikxNWHH695MUCA977t7gySD5X1P3BJuTEwPZRkYGDsWwokpm5mAxLb2BkYAv/fvXbNGqJccc+ePbv5mMTFZ8wC'
    '8vI2sjAw8N85U8ME5HCccIkoZGA44i6098StOawMDFysIB3Ms1OAZNWFXgYG033xvQzcZxRjehn6d+YuPODqkpIyb5'
    'ctUDq6C+ochjl79mxlYHgoLi7CwH7X0YWNQfJx85QLPCCpVYFBcxlYT5lxrTl5uQdoIyfYfLFlzEDXbo0HOedlrgyD'
    'zOvi3PvymdMYGNqL3fcyM24IYew7d3o6UBELMHxUge7fI8csI6P9ghuoo6APSDDdVAYFxCaQaTtdgYTSJUaYcxiS9u'
    'wKZ9A+Lyh6XVr7NK/wVVmW409f7mZKXsLEsjGkGKh9XhzfziNHVgFN4wKFf9KBnR4MTudldB8qlTWB3Gxyw8LzmRSD'
    '89xPJUDpsD1Ah4vckmYgCnBKgMjwwwgRAEq3i4o=')
DIGITS = '0123456789'
GLYPH_SIZES = {'stamp': {'scale': 1.0, 'thickness': 2, 'shape': (10, 22, 19), 'top': -21,
                         'left': 0, 'advance': 18, 'data': _STAMP},
               'index': {'scale': 0.4, 'thickness': 1, 'shape': (10, 10, 7), 'top': -9,
                         'left': 0, 'advance': 7, 'data': _INDEX},
               'score': {'scale': 0.35, 'thickness': 1, 'line_type': 'LINE_8',
                         'chars': DIGITS + '.', 'shape': (11, 8, 6), 'top': -7, 'left': 0,
                         'advance': 5, 'advances': {'.': 2}, 'data': _SCORE}}


@functools.lru_cache(maxsize=None)
def glyph_table(size: str) -> np.ndarray:
    '''(n, gh, gw) uint8 coverage of the size's characters (the digits 0-9,
    and '.' for 'score') at ``size`` ('stamp', 'index' or 'score').'''
    spec = GLYPH_SIZES[size]
    raw = zlib.decompress(base64.b64decode(''.join(spec['data'])))
    table = np.frombuffer(raw, np.uint8).reshape(spec['shape'])
    table.flags.writeable = False
    return table


# -- the plain versions ----------------------------------------------------------

def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    '''``cv::clipLine`` on a (w, h) box: (inside, x1, y1, x2, y2).'''
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
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
    return (c1 | c2) == 0, x1, y1, x2, y2


def _put_aa(img: np.ndarray, x: int, y: int, a: int, color: Sequence[int]) -> None:
    px = img[y:y + 1, x:x + 1].reshape(-1)
    for c in range(px.shape[0]):
        v = int(px[c])
        v += ((color[c] - v) * a + 127) >> 8
        v += ((color[c] - v) * a + 127) >> 8
        px[c] = v


def _line_aa_fixed(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
                   color: Sequence[int]) -> None:
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    horizontal = abs(dx) > abs(dy)
    if horizontal:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _trunc_div(dy << XY_SHIFT, abs(dx) | 1)
        x2 += XY_ONE
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
        y1 += ((step * -(x1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
        i, j = (x1 >> (XY_SHIFT - 7)) & 0x78, (x2 >> (XY_SHIFT - 7)) & 0x78
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _trunc_div(dx << XY_SHIFT, abs(dy) | 1)
        y2 += XY_ONE
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
        x1 += ((step * -(y1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
        i, j = (y1 >> (XY_SHIFT - 7)) & 0x78, (y2 >> (XY_SHIFT - 7)) & 0x78
    slope = ((step >> (XY_SHIFT - 5)) & 0x3f) ^ (0x3f if step < 0 else 0)
    slope = 0x100 if slope & 0x20 else SLOPE[slope]
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    ep = [0, ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff, (t1 >> 8) & 0x1ff,
          ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff,
          ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff, ((t1 + t0) >> 8) & 0x1ff,
          (t2 >> 8) & 0x1ff, ((t2 + t0) >> 8) & 0x1ff, slope]
    # the run's position along its major axis, and the minor coordinate
    major, minor = (x1 >> XY_SHIFT, y1) if horizontal else (y1 >> XY_SHIFT, x1)
    major_size, minor_size = (w, h) if horizontal else (h, w)
    scount = 0
    while ecount >= 0:
        if 0 <= major < major_size:
            base = (minor >> XY_SHIFT) - 1
            corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                      (((ecount >= 2) + 1) & (ecount | 2))]
            dist = (minor >> (XY_SHIFT - 5)) & 31
            for k, tap in enumerate((dist + 32, dist, 63 - dist)):
                if 0 <= base + k < minor_size:
                    a = (corr * FILTER[tap] >> 8) & 0xff
                    if horizontal:
                        _put_aa(img, major, base + k, a, color)
                    else:
                        _put_aa(img, base + k, major, a, color)
        major += 1
        minor += step
        scount += 1
        ecount -= 1


def line_aa(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
            color: Sequence[int]) -> None:
    '''``cv2.line(img, p0, p1, color, 1, cv2.LINE_AA)`` in place; ``img`` is
    (H, W) or (H, W, C) uint8, ``color`` one value per channel.'''
    _line_aa_fixed(img, int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT,
                   int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT, color)


def _fill_convex_aa(img: np.ndarray, v: List[Tuple[int, int]], color: Sequence[int]) -> None:
    '''OpenCV's ``FillConvexPoly`` with LINE_AA, points in 16-bit fixed point.'''
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line_aa_fixed(img, p0[0], p0[1], p[0], p[1], color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{'idx': imin, 'di': 1, 'x': -XY_ONE, 'dx': 0, 'ye': ymin},
            {'idx': imin, 'di': npts - 1, 'x': -XY_ONE, 'dx': 0, 'ye': ymin}]
    edges = npts
    y = ymin
    while True:
        if y < ymax or y == ymin:
            for e in edge:
                if y < e['ye']:
                    continue
                idx0 = e['idx']
                idx = (idx0 + e['di']) % npts
                while True:
                    # C's ``edges-- > 0``: the count drops on the failing test too
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        e.update(ye=ty, x=v[idx0][0], idx=idx,
                                 dx=_trunc_div((v[idx][0] - v[idx0][0]) * 2 + (ty - y),
                                               2 * (ty - y)))
                        break
                    idx0, idx = idx, (idx + e['di']) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0]['x'] > edge[1]['x'] else (edge[0], edge[1])
            xx1 = (left['x'] + XY_ONE - 1) >> XY_SHIFT
            xx2 = right['x'] >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = np.asarray(color, np.uint8) \
                    if img.ndim == 3 else color[0]
        edge[0]['x'] += edge[0]['dx']
        edge[1]['x'] += edge[1]['dx']
        y += 1
        if y > ymax:
            break


def circle_aa(img: np.ndarray, center: Tuple[int, int], radius: int,
              color: Sequence[int]) -> None:
    '''``cv2.circle(img, center, radius, color, -1, cv2.LINE_AA)`` in place,
    for radius 0-2 (``ellipse2Poly``'s 90-degree step; radius 0 is its
    two-point polygon, which draws its edges only).'''
    if radius >= 3:
        raise ValueError('circle_aa draws radius < 3 only')
    x, y, r = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT, int(radius) << XY_SHIFT
    # EllipseEx drops repeated points, and a single point becomes two
    pts = [(x + r, y), (x, y + r), (x - r, y), (x, y - r), (x + r, y)] if r else [(x, y)] * 2
    _fill_convex_aa(img, pts, color)


def rectangle(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
              color: Sequence[int]) -> None:
    '''``cv2.rectangle(img, p0, p1, color)`` (thickness 1, LINE_8) in place.'''
    h, w = img.shape[:2]
    (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    value = np.asarray(color, np.uint8) if img.ndim == 3 else color[0]
    for y in (y0, y1):
        if 0 <= y < h and max(min(x0, x1), 0) <= min(max(x0, x1), w - 1):
            img[y, max(min(x0, x1), 0):min(max(x0, x1), w - 1) + 1] = value
    for x in (x0, x1):
        if 0 <= x < w and max(min(y0, y1), 0) <= min(max(y0, y1), h - 1):
            img[max(min(y0, y1), 0):min(max(y0, y1), h - 1) + 1, x] = value


def draw_contours_aa(img: np.ndarray, contours: Iterable[np.ndarray],
                     color: Sequence[int]) -> None:
    '''``cv2.drawContours(img, contours, -1, color, 1, cv2.LINE_AA)`` in
    place: each contour's edges from each point to the next, closing back to
    the first.'''
    for contour in contours:
        pts = np.asarray(contour).reshape(-1, 2).tolist()
        for j, p in enumerate(pts):
            line_aa(img, p, pts[(j + 1) % len(pts)], color)


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], size: str,
             color: Sequence[int]) -> None:
    '''``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness, line_type)`` in place at ``size`` (``GLYPH_SIZES``), for text
    of that size's characters; clipped at every edge of the image.'''
    spec, table = GLYPH_SIZES[size], glyph_table(size)
    chars, advances = spec.get('chars', DIGITS), spec.get('advances', {})
    if any(ch not in chars for ch in text):
        raise ValueError(f'{text!r}: size {size!r} draws only {chars!r}')
    h, w = img.shape[:2]
    gh, gw = table.shape[1:]
    x = int(org[0])
    for ch in text:
        y0, x0 = int(org[1]) + spec['top'], x + spec['left']
        ys0, xs0 = max(0, -y0), max(0, -x0)
        ys1, xs1 = min(gh, h - y0), min(gw, w - x0)
        if ys1 > ys0 and xs1 > xs0:
            a = table[chars.index(ch), ys0:ys1, xs0:xs1].astype(np.int64)
            region = img[y0 + ys0:y0 + ys1, x0 + xs0:x0 + xs1]
            if img.ndim == 3:
                a, c = a[..., None], np.asarray(color[:img.shape[2]], np.int64)
            else:
                c = int(color[0])
            region[...] = (region.astype(np.int64) * (255 - a) + c * a + 127) // 255
        x += advances.get(ch, spec['advance'])


def put_number(img: np.ndarray, value: int, org: Tuple[int, int], size: str,
               color: Sequence[int]) -> None:
    '''``cv2.putText(img, str(value), org, FONT_HERSHEY_SIMPLEX, scale,
    color, thickness, LINE_AA)`` in place for a non-negative integer, at
    ``size`` 'stamp' (scale 1, thickness 2) or 'index' (0.4, 1).'''
    put_text(img, str(int(value)), org, size, color)


def _linear_taps(src: int, dst: int, clamp: bool):
    scale = src / dst
    lo, hi, w0, w1 = [], [], [], []
    for d in range(dst):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = int(np.floor(f))
        f = np.float32(f - np.float32(s))
        if clamp and s < 0:
            f, s = np.float32(0), 0
        if clamp and s >= src - 1:
            f, s = np.float32(0), src - 1
        lo.append(min(max(s, 0), src - 1))
        hi.append(min(max(s + 1, 0), src - 1))
        w0.append(int(np.rint((np.float32(1) - f) * np.float32(2048))))
        w1.append(int(np.rint(f * np.float32(2048))))
    return np.array(lo), np.array(hi), np.array(w0, np.int64), np.array(w1, np.int64)


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    '''``cv2.resize(img, size)`` (``size`` is (width, height), INTER_LINEAR)
    of an (H, W) or (H, W, C) uint8 image.'''
    dw, dh = int(size[0]), int(size[1])
    src = np.asarray(img)
    s3 = src.reshape(src.shape[0], src.shape[1], -1).astype(np.int64)
    xlo, xhi, xw0, xw1 = _linear_taps(src.shape[1], dw, True)
    ylo, yhi, yw0, yw1 = _linear_taps(src.shape[0], dh, False)
    horiz = s3[:, xlo] * xw0[None, :, None] + s3[:, xhi] * xw1[None, :, None]
    r0 = np.clip(horiz[ylo] >> 4, -32768, 32767)
    r1 = np.clip(horiz[yhi] >> 4, -32768, 32767)
    m = ((r0 * yw0[:, None, None]) >> 16) + ((r1 * yw1[:, None, None]) >> 16)
    out = np.clip((m + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((dh, dw) + src.shape[2:])


@functools.lru_cache(maxsize=64)
def blend_lut(color: Tuple[int, ...], alpha: float) -> np.ndarray:
    '''(C, 256) table v -> uint8(v * (1 - alpha) + c * alpha) in f32,
    truncated (``viz.py:_blend_mask``'s table).'''
    v = np.arange(256, dtype='float32')
    lut = np.stack([(v * (1 - alpha) + c * alpha).astype('uint8') for c in color], axis=0)
    lut.flags.writeable = False
    return lut


def blend_mask(image: np.ndarray, mask: np.ndarray, color=(0, 0, 255),
               alpha: float = 0.3) -> None:
    '''Blend ``color`` into ``image`` (H, W, C) where ``mask`` (H, W) is
    non-zero, in place, through ``blend_lut``.'''
    lut = blend_lut(tuple(int(c) for c in color), float(alpha))
    sub = np.asarray(mask) > 0
    blended = np.empty_like(image)
    for ch in range(image.shape[-1]):
        blended[..., ch] = lut[ch][image[..., ch]]
    np.copyto(image, blended, where=sub[..., None])


# -- the C++ core ----------------------------------------------------------------

LINE_AA, CIRCLE_AA, RECT, TEXT = 0, 1, 2, 3
_SIZE_INDEX = {'stamp': 0, 'index': 1}


@functools.lru_cache(maxsize=None)
def _glyph_args():
    tables = [glyph_table(s) for s in ('stamp', 'index')]
    data = np.ascontiguousarray(np.concatenate([t.reshape(-1) for t in tables]))
    meta, offset = [], 0
    for size, table in zip(('stamp', 'index'), tables):
        spec = GLYPH_SIZES[size]
        meta += [offset, table.shape[1], table.shape[2], spec['top'], spec['left'],
                 spec['advance']]
        offset += table.size
    return data, np.asarray(meta, np.int32)


def _ptr(array: np.ndarray, ctype=ctypes.c_uint8):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


class DrawList:
    '''Drawing records for a block of frames, drawn in their order by one
    call of the C++ core (``draw``) or by the plain versions
    (``draw_plain``). Coordinates are whole pixels; colours one value per
    channel of the frames drawn on.'''

    def __init__(self):
        self._records: List[List[int]] = []

    def _add(self, frame: int, kind: int, *args: int) -> None:
        record = [int(frame), kind, *(int(a) for a in args)]
        self._records.append(record + [0] * (10 - len(record)))

    @staticmethod
    def _color(color: Sequence[int]) -> List[int]:
        color = [int(c) for c in color]
        return (color * 3)[:3] if len(color) == 1 else color

    def line(self, frame: int, p0, p1, color) -> None:
        self._add(frame, LINE_AA, p0[0], p0[1], p1[0], p1[1], *self._color(color))

    def circle(self, frame: int, center, radius: int, color) -> None:
        if radius >= 3:
            raise ValueError('DrawList.circle draws radius < 3 only')
        self._add(frame, CIRCLE_AA, center[0], center[1], radius, *self._color(color))

    def rectangle(self, frame: int, p0, p1, color) -> None:
        self._add(frame, RECT, p0[0], p0[1], p1[0], p1[1], *self._color(color))

    def number(self, frame: int, value: int, org, size: str, color) -> None:
        if value < 0:
            raise ValueError('DrawList.number draws non-negative integers only')
        self._add(frame, TEXT, _SIZE_INDEX[size], org[0], org[1], value, *self._color(color))

    def contours(self, frame: int, contours: Iterable[np.ndarray], color) -> None:
        '''``draw_contours_aa``'s lines.'''
        for contour in contours:
            pts = np.asarray(contour).reshape(-1, 2).tolist()
            for j, p in enumerate(pts):
                self.line(frame, p, pts[(j + 1) % len(pts)], color)

    def records(self) -> np.ndarray:
        '''(n, 10) int32: frame, kind, then the kind's arguments.'''
        return np.asarray(self._records, np.int32).reshape(-1, 10)

    def draw(self, frames: np.ndarray) -> np.ndarray:
        '''Draw every record onto (N, H, W) or (N, H, W, 3) C-contiguous uint8
        ``frames`` in place, in one call of the C++ core; raises if it fails.'''
        if frames.dtype != np.uint8 or not frames.flags.c_contiguous or \
                frames.ndim not in (3, 4) or not frames.flags.writeable:
            raise ValueError('frames must be writable C-contiguous (N, H, W[, 3]) uint8')
        records = np.ascontiguousarray(self.records())
        data, meta = _glyph_args()
        n, h, w = frames.shape[:3]
        cn = frames.shape[3] if frames.ndim == 4 else 1
        rc = native.load_draw_library().m2de_draw_ops(
            _ptr(frames), n, h, w, cn, _ptr(records, ctypes.c_int32), len(records),
            _ptr(data), _ptr(meta, ctypes.c_int32))
        if rc != 0:
            raise RuntimeError(f'm2de_draw_ops returned {rc}')
        return frames

    def draw_plain(self, frames: np.ndarray) -> np.ndarray:
        '''``draw`` with the plain versions, record by record.'''
        for frame, kind, *a in self.records().tolist():
            img = frames[frame]
            cn = img.shape[2] if img.ndim == 3 else 1
            if kind == LINE_AA:
                line_aa(img, a[0:2], a[2:4], a[4:4 + cn])
            elif kind == CIRCLE_AA:
                circle_aa(img, a[0:2], a[2], a[3:3 + cn])
            elif kind == RECT:
                rectangle(img, a[0:2], a[2:4], a[4:4 + cn])
            else:
                put_number(img, a[3], a[1:3], ('stamp', 'index')[a[0]], a[4:4 + cn])
        return frames


def resize_linear_block(frames: np.ndarray, size: Tuple[int, int],
                        out: np.ndarray = None) -> np.ndarray:
    '''``resize_linear`` of every frame of an (N, H, W[, C]) uint8 block in
    one call of the C++ core; ``size`` is (width, height); ``out`` (N, h, w[,
    C]) is written when given.'''
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w = frames.shape[:3]
    cn = frames.shape[3] if frames.ndim == 4 else 1
    dw, dh = int(size[0]), int(size[1])
    shape = (n, dh, dw) + frames.shape[3:]
    if out is None:
        out = np.empty(shape, np.uint8)
    elif out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f'out must be C-contiguous {shape} uint8')
    rc = native.load_draw_library().m2de_resize_linear_u8(_ptr(frames), n, h, w, cn,
                                                          _ptr(out), dh, dw)
    if rc != 0:
        raise RuntimeError(f'm2de_resize_linear_u8 returned {rc}')
    return out


def blend_windows(frames: np.ndarray, masks: np.ndarray, origins, color,
                  alpha: float) -> np.ndarray:
    '''``blend_mask`` of each frame of (N, H, W, C) uint8 ``frames`` through
    its (mh, mw) mask placed at its [y0, x0] origin (``origins`` (N, 2), or
    None for the frame's corner), in one call of the C++ core, in place.'''
    if frames.dtype != np.uint8 or not frames.flags.c_contiguous or frames.ndim != 4:
        raise ValueError('frames must be C-contiguous (N, H, W, C) uint8')
    masks = np.ascontiguousarray(masks, dtype=np.uint8)
    n, h, w, cn = frames.shape
    if masks.shape[0] != n:
        raise ValueError('one mask per frame')
    lut = np.ascontiguousarray(blend_lut(tuple(int(c) for c in color), float(alpha)))
    org = None if origins is None else np.ascontiguousarray(origins, dtype=np.int64)
    if org is not None and org.shape != (n, 2):
        raise ValueError('origins must be (N, 2)')
    rc = native.load_draw_library().m2de_blend_windows(
        _ptr(frames), n, h, w, cn, _ptr(masks), masks.shape[1], masks.shape[2],
        None if org is None else _ptr(org, ctypes.c_int64), _ptr(lut))
    if rc != 0:
        raise RuntimeError(f'm2de_blend_windows returned {rc}')
    return frames
