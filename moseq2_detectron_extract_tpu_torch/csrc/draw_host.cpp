// The preview's drawing on the host: the primitives of OpenCV that the
// preview calls, written out so that they give its pixels, for a whole
// block of frames in one call.
//
// m2de_draw_ops draws a list of records onto (n, h, w, cn) uint8 frames, in
// the records' order:
//   LINE_AA  (x0, y0, x1, y1, c0, c1, c2)   cv2.line(..., 1, LINE_AA)
//   CIRCLE_AA (cx, cy, r, c0, c1, c2)       cv2.circle(..., r, -1, LINE_AA), r < 3
//   RECT     (x0, y0, x1, y1, c0, c1, c2)   cv2.rectangle(..., thickness 1, LINE_8)
//   TEXT     (size, x, y, value, c0, c1, c2) cv2.putText of a non-negative integer
// Lines follow OpenCV's LineAA (16-bit fixed point, its filter and slope
// tables, each touched pixel blended twice); the filled circle is its
// FillConvexPoly of the 5-point polygon ellipse2Poly gives below radius 3;
// the text is cv2's digit glyphs as coverage tables (ops/draw.py), blended
// as (v * (255 - a) + c * a + 127) / 255.
//
// m2de_resize_linear_u8 is cv2.resize(INTER_LINEAR) on uint8: 11-bit
// coefficients, the horizontal pass in int32, the vertical pass as
// OpenCV's vector code rounds it.
//
// m2de_blend_windows blends a colour into frames through per-frame masks at
// per-frame origins, by a (cn, 256) table (viz.py:_blend_mask).
//
// ops/draw.py holds the plain version of each, which the tests hold this
// file to.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kShift = 16;
constexpr int64_t kOne = int64_t(1) << kShift;

const int kSlopeCorr[32] = {181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194,
                            196, 198, 201, 203, 206, 209, 211, 214, 218, 221, 224, 227, 231,
                            235, 238, 242, 246, 250, 254};
const int kFilter[64] = {168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249,
                         252, 254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218,
                         210, 202, 194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105,
                         97,  89,  82,  75,  68,  62,  56,  50,  45,  40,  36,  32,  28,
                         25,  22,  19,  16,  14,  12,  11,  9,   8,   7,   5,   5};

enum Kind { LINE_AA = 0, CIRCLE_AA = 1, RECT = 2, TEXT = 3 };
constexpr int kRecord = 10;  // frame, kind, 8 arguments

struct Image {
  uint8_t* data;
  int h, w, cn;
  uint8_t* at(int x, int y) const { return data + (size_t(y) * w + x) * cn; }
};

// OpenCV's blend of one anti-aliased tap, applied twice.
inline void put_aa(const Image& im, int x, int y, int a, const int* color) {
  uint8_t* p = im.at(x, y);
  for (int c = 0; c < im.cn; ++c) {
    int v = p[c];
    v += ((color[c] - v) * a + 127) >> 8;
    v += ((color[c] - v) * a + 127) >> 8;
    p[c] = uint8_t(v);
  }
}

// cv::clipLine on a (w, h) box of 16-bit fixed-point coordinates.
bool clip_line(int64_t w, int64_t h, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2) {
  const int64_t right = w - 1, bottom = h - 1;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += int64_t(double(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += int64_t(double(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += int64_t(double(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += int64_t(double(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// OpenCV's LineAA between 16-bit fixed-point end points.
void line_aa(const Image& im, int64_t x1, int64_t y1, int64_t x2, int64_t y2, const int* color) {
  if (!clip_line(int64_t(im.w) << kShift, int64_t(im.h) << kShift, x1, y1, x2, y2)) return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  const int64_t ax = dx < 0 ? -dx : dx, ay = dy < 0 ? -dy : dy;
  int64_t x_step, y_step, i, j;
  int ecount, slope;
  const bool horizontal = ax > ay;
  if (horizontal) {
    if (dx < 0) {
      dy = -dy;
      std::swap(x1, x2);
      std::swap(y1, y2);
    }
    x_step = kOne;
    y_step = (dy << kShift) / (ax | 1);
    x2 += kOne;
    ecount = int((x2 >> kShift) - (x1 >> kShift));
    j = -(x1 & (kOne - 1));
    y1 += ((y_step * j) >> kShift) + (kOne >> 1);
    slope = int((y_step >> (kShift - 5)) & 0x3f);
    slope ^= (y_step < 0 ? 0x3f : 0);
    i = (x1 >> (kShift - 7)) & 0x78;
    j = (x2 >> (kShift - 7)) & 0x78;
  } else {
    if (dy < 0) {
      dx = -dx;
      std::swap(x1, x2);
      std::swap(y1, y2);
    }
    x_step = (dx << kShift) / (ay | 1);
    y_step = kOne;
    y2 += kOne;
    ecount = int((y2 >> kShift) - (y1 >> kShift));
    j = -(y1 & (kOne - 1));
    x1 += ((x_step * j) >> kShift) + (kOne >> 1);
    slope = int((x_step >> (kShift - 5)) & 0x3f);
    slope ^= (x_step < 0 ? 0x3f : 0);
    i = (y1 >> (kShift - 7)) & 0x78;
    j = (y2 >> (kShift - 7)) & 0x78;
  }
  slope = (slope & 0x20) ? 0x100 : kSlopeCorr[slope];
  int ep[9];
  {
    const int t0 = slope << 7;
    const int t1 = int(((0x78 - i) | 4) * slope);
    const int t2 = int((j | 4) * slope);
    ep[0] = 0;
    ep[8] = slope;
    ep[1] = ep[3] = int(((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff);
    ep[2] = (t1 >> 8) & 0x1ff;
    ep[4] = int(((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff);
    ep[5] = ((t1 + t0) >> 8) & 0x1ff;
    ep[6] = (t2 >> 8) & 0x1ff;
    ep[7] = ((t2 + t0) >> 8) & 0x1ff;
  }
  int scount = 0;
  if (horizontal) {
    for (int x = int(x1 >> kShift); ecount >= 0; x++, y1 += y_step, scount++, ecount--) {
      if (unsigned(x) >= unsigned(im.w)) continue;
      const int y = int((y1 >> kShift) - 1);
      const int corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                          (((ecount >= 2) + 1) & (ecount | 2))];
      const int dist = int((y1 >> (kShift - 5)) & 31);
      const int taps[3] = {dist + 32, dist, 63 - dist};
      for (int k = 0; k < 3; ++k)
        if (unsigned(y + k) < unsigned(im.h))
          put_aa(im, x, y + k, (corr * kFilter[taps[k]] >> 8) & 0xff, color);
    }
  } else {
    for (int y = int(y1 >> kShift); ecount >= 0; y++, x1 += x_step, scount++, ecount--) {
      if (unsigned(y) >= unsigned(im.h)) continue;
      const int x = int((x1 >> kShift) - 1);
      const int corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                          (((ecount >= 2) + 1) & (ecount | 2))];
      const int dist = int((x1 >> (kShift - 5)) & 31);
      const int taps[3] = {dist + 32, dist, 63 - dist};
      for (int k = 0; k < 3; ++k)
        if (unsigned(x + k) < unsigned(im.w))
          put_aa(im, x + k, y, (corr * kFilter[taps[k]] >> 8) & 0xff, color);
    }
  }
}

void hline(const Image& im, int y, int x1, int x2, const int* color) {
  for (int x = x1; x <= x2; ++x) {
    uint8_t* p = im.at(x, y);
    for (int c = 0; c < im.cn; ++c) p[c] = uint8_t(color[c]);
  }
}

// OpenCV's FillConvexPoly with LINE_AA, points in 16-bit fixed point.
void fill_convex_aa(const Image& im, const int64_t (*v)[2], int npts, const int* color) {
  const int64_t delta = kOne >> 1;
  const int64_t delta1 = kOne - 1, delta2 = 0;
  int64_t p0x = v[npts - 1][0], p0y = v[npts - 1][1];
  int64_t xmin = v[0][0], xmax = v[0][0], ymin = v[0][1], ymax = v[0][1];
  int imin = 0;
  for (int i = 0; i < npts; ++i) {
    const int64_t px = v[i][0], py = v[i][1];
    if (py < ymin) {
      ymin = py;
      imin = i;
    }
    ymax = std::max(ymax, py);
    xmax = std::max(xmax, px);
    xmin = std::min(xmin, px);
    line_aa(im, p0x, p0y, px, py, color);
    p0x = px;
    p0y = py;
  }
  xmin = (xmin + delta) >> kShift;
  xmax = (xmax + delta) >> kShift;
  ymin = (ymin + delta) >> kShift;
  ymax = (ymax + delta) >> kShift;
  if (npts < 3 || xmax < 0 || ymax < 0 || xmin >= im.w || ymin >= im.h) return;
  ymax = std::min<int64_t>(ymax, im.h - 1);
  struct Edge {
    int idx, di;
    int64_t x, dx;
    int ye;
  } edge[2];
  int y = int(ymin);
  edge[0].idx = edge[1].idx = imin;
  edge[0].ye = edge[1].ye = y;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -kOne;
  edge[0].dx = edge[1].dx = 0;
  int edges = npts;
  do {
    if (y < int(ymax) || y == int(ymin)) {
      for (int i = 0; i < 2; ++i) {
        if (y >= edge[i].ye) {
          int idx0 = edge[i].idx, di = edge[i].di;
          int idx = idx0 + di;
          if (idx >= npts) idx -= npts;
          for (; edges-- > 0;) {
            const int ty = int((v[idx][1] + delta) >> kShift);
            if (ty > y) {
              const int64_t xs = v[idx0][0], xe = v[idx][0];
              edge[i].ye = ty;
              edge[i].dx = ((xe - xs) * 2 + (int64_t(ty) - y)) / (2 * (int64_t(ty) - y));
              edge[i].x = xs;
              edge[i].idx = idx;
              break;
            }
            idx0 = idx;
            idx += di;
            if (idx >= npts) idx -= npts;
          }
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      const int left = edge[0].x > edge[1].x ? 1 : 0, right = 1 - left;
      int xx1 = int((edge[left].x + delta1) >> kShift);
      int xx2 = int((edge[right].x + delta2) >> kShift);
      if (xx2 >= 0 && xx1 < im.w) {
        xx1 = std::max(xx1, 0);
        xx2 = std::min(xx2, im.w - 1);
        hline(im, y, xx1, xx2, color);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= int(ymax));
}

void circle_aa(const Image& im, int cx, int cy, int r, const int* color) {
  const int64_t x = int64_t(cx) << kShift, y = int64_t(cy) << kShift, rr = int64_t(r) << kShift;
  const int64_t v[5][2] = {{x + rr, y}, {x, y + rr}, {x - rr, y}, {x, y - rr}, {x + rr, y}};
  // EllipseEx drops repeated points, and a single point becomes two
  fill_convex_aa(im, v, r ? 5 : 2, color);
}

// One axis-parallel run of cv2.line (LINE_8), clipped to the frame.
void segment(const Image& im, int x0, int y0, int x1, int y1, const int* color) {
  if (y0 == y1) {
    if (y0 < 0 || y0 >= im.h) return;
    int a = std::max(std::min(x0, x1), 0), b = std::min(std::max(x0, x1), im.w - 1);
    if (a <= b) hline(im, y0, a, b, color);
  } else {
    if (x0 < 0 || x0 >= im.w) return;
    int a = std::max(std::min(y0, y1), 0), b = std::min(std::max(y0, y1), im.h - 1);
    for (int y = a; y <= b; ++y) hline(im, y, x0, x0, color);
  }
}

void rectangle(const Image& im, int x0, int y0, int x1, int y1, const int* color) {
  segment(im, x0, y0, x1, y0, color);
  segment(im, x1, y0, x1, y1, color);
  segment(im, x1, y1, x0, y1, color);
  segment(im, x0, y1, x0, y0, color);
}

struct Glyphs {
  const uint8_t* bytes;  // 10 digits of (gh, gw) coverage each
  int gh, gw, top, left, advance;
};

void put_number(const Image& im, const Glyphs& g, int x, int y, long long value, const int* color) {
  char text[24];
  int len = 0;
  do {
    text[len++] = char('0' + value % 10);
    value /= 10;
  } while (value > 0 && len < 23);
  for (int k = len - 1; k >= 0; --k, x += g.advance) {
    const uint8_t* glyph = g.bytes + size_t(text[k] - '0') * g.gh * g.gw;
    const int y0 = y + g.top, x0 = x + g.left;
    for (int gy = std::max(0, -y0); gy < g.gh && y0 + gy < im.h; ++gy) {
      for (int gx = std::max(0, -x0); gx < g.gw && x0 + gx < im.w; ++gx) {
        const int a = glyph[gy * g.gw + gx];
        if (!a) continue;
        uint8_t* p = im.at(x0 + gx, y0 + gy);
        for (int c = 0; c < im.cn; ++c) p[c] = uint8_t((p[c] * (255 - a) + color[c] * a + 127) / 255);
      }
    }
  }
}

// cv2's INTER_LINEAR tap and 11-bit weights of one output coordinate; the
// x axis clamps the tap at the borders, the y axis clamps the rows only.
void linear_taps(int src, int dst, bool clamp, int* lo, int* hi, int* w0, int* w1) {
  const double scale = double(src) / dst;
  for (int d = 0; d < dst; ++d) {
    float f = float((d + 0.5) * scale - 0.5);
    int s = int(std::floor(f));
    f -= float(s);
    if (clamp && s < 0) f = 0.f, s = 0;
    if (clamp && s >= src - 1) f = 0.f, s = src - 1;
    lo[d] = std::min(std::max(s, 0), src - 1);
    hi[d] = std::min(std::max(s + 1, 0), src - 1);
    w0[d] = int(std::lrint((1.f - f) * 2048.f));
    w1[d] = int(std::lrint(f * 2048.f));
  }
}

inline int sat16(int v) { return std::min(std::max(v, -32768), 32767); }

}  // namespace

extern "C" {

int m2de_draw_ops(uint8_t* frames, int n, int h, int w, int cn, const int32_t* ops, int nops,
                  const uint8_t* glyph_bytes, const int32_t* glyph_meta) {
  if (cn != 1 && cn != 3) return 1;
  Glyphs glyphs[2];
  for (int s = 0; s < 2; ++s) {
    const int32_t* m = glyph_meta + 6 * s;  // byte offset, gh, gw, top, left, advance
    glyphs[s] = {glyph_bytes + m[0], m[1], m[2], m[3], m[4], m[5]};
  }
  for (int k = 0; k < nops; ++k) {
    const int32_t* r = ops + size_t(k) * kRecord;
    if (r[0] < 0 || r[0] >= n) return 2;
    const Image im{frames + size_t(r[0]) * h * w * cn, h, w, cn};
    const int32_t* a = r + 2;
    switch (r[1]) {
      case LINE_AA: {
        const int color[3] = {a[4], a[5], a[6]};
        line_aa(im, int64_t(a[0]) << kShift, int64_t(a[1]) << kShift, int64_t(a[2]) << kShift,
                int64_t(a[3]) << kShift, color);
        break;
      }
      case CIRCLE_AA: {
        if (a[2] >= 3) return 3;
        const int color[3] = {a[3], a[4], a[5]};
        circle_aa(im, a[0], a[1], a[2], color);
        break;
      }
      case RECT: {
        const int color[3] = {a[4], a[5], a[6]};
        rectangle(im, a[0], a[1], a[2], a[3], color);
        break;
      }
      case TEXT: {
        if (a[0] < 0 || a[0] > 1 || a[3] < 0) return 4;
        const int color[3] = {a[4], a[5], a[6]};
        put_number(im, glyphs[a[0]], a[1], a[2], a[3], color);
        break;
      }
      default:
        return 5;
    }
  }
  return 0;
}

int m2de_resize_linear_u8(const uint8_t* src, int n, int h, int w, int cn, uint8_t* dst, int dh,
                          int dw) {
  if (n < 0 || h <= 0 || w <= 0 || dh <= 0 || dw <= 0 || cn <= 0) return 1;
  int *xlo = new int[dw], *xhi = new int[dw], *xw0 = new int[dw], *xw1 = new int[dw];
  int *ylo = new int[dh], *yhi = new int[dh], *yw0 = new int[dh], *yw1 = new int[dh];
  linear_taps(w, dw, true, xlo, xhi, xw0, xw1);
  linear_taps(h, dh, false, ylo, yhi, yw0, yw1);
  const int row = dw * cn;
  int* horiz = new int[size_t(h) * row];
  for (int f = 0; f < n; ++f) {
    const uint8_t* s = src + size_t(f) * h * w * cn;
    uint8_t* d = dst + size_t(f) * dh * dw * cn;
    for (int y = 0; y < h; ++y) {
      const uint8_t* sr = s + size_t(y) * w * cn;
      int* hr = horiz + size_t(y) * row;
      for (int x = 0; x < dw; ++x)
        for (int c = 0; c < cn; ++c)
          hr[x * cn + c] = sr[xlo[x] * cn + c] * xw0[x] + sr[xhi[x] * cn + c] * xw1[x];
    }
    for (int y = 0; y < dh; ++y) {
      const int* r0 = horiz + size_t(ylo[y]) * row;
      const int* r1 = horiz + size_t(yhi[y]) * row;
      uint8_t* dr = d + size_t(y) * row;
      for (int x = 0; x < row; ++x) {
        // the vector code's rounding: each row >> 4 to int16, a high
        // multiply (>> 16) by its weight, the sum rounded >> 2, saturated
        const int m = ((sat16(r0[x] >> 4) * yw0[y]) >> 16) + ((sat16(r1[x] >> 4) * yw1[y]) >> 16);
        dr[x] = uint8_t(std::min(std::max((m + 2) >> 2, 0), 255));
      }
    }
  }
  delete[] horiz;
  delete[] xlo, delete[] xhi, delete[] xw0, delete[] xw1;
  delete[] ylo, delete[] yhi, delete[] yw0, delete[] yw1;
  return 0;
}

int m2de_blend_windows(uint8_t* frames, int n, int h, int w, int cn, const uint8_t* masks, int mh,
                       int mw, const int64_t* origins, const uint8_t* lut) {
  for (int f = 0; f < n; ++f) {
    const int64_t y0 = origins ? origins[2 * f] : 0, x0 = origins ? origins[2 * f + 1] : 0;
    const uint8_t* m = masks + size_t(f) * mh * mw;
    uint8_t* im = frames + size_t(f) * h * w * cn;
    for (int y = 0; y < mh; ++y) {
      const int64_t yy = y0 + y;
      if (yy < 0 || yy >= h) continue;
      for (int x = 0; x < mw; ++x) {
        const int64_t xx = x0 + x;
        if (!m[y * mw + x] || xx < 0 || xx >= w) continue;
        uint8_t* p = im + (size_t(yy) * w + xx) * cn;
        for (int c = 0; c < cn; ++c) p[c] = lut[c * 256 + p[c]];
      }
    }
  }
  return 0;
}
}
