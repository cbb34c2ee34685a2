// A baseline JPEG encoder for the preview's Motion-JPEG frames.
//
// Each frame: RGB (or BGR) uint8 (h, w, 3) -> JFIF YCbCr (16-bit fixed
// point) -> 4:2:0 (the mean of each 2x2, rounded) -> 8x8 integer DCT
// (13-bit cosine matrix, rows then columns) -> quantisation by the Annex K
// tables scaled to the quality as libjpeg scales them (half away from zero)
// -> Huffman coding with the Annex K tables. The frame is padded to whole
// 16x16 MCUs by repeating its last row and column; the decoder crops.
//
// m2de_jpeg_encode_block encodes a block of frames on a few threads
// (frames are independent); m2de_jpeg_forward gives one frame's quantised
// coefficients, which io/mjpeg.py's plain numpy version is held to.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                        14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                        18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                          24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                          99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                          99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huffman {
  uint16_t code[256];
  uint8_t size[256];
};

// Annex C: canonical codes from the count of codes of each length.
Huffman make_huffman(const uint8_t* bits, const uint8_t* vals) {
  Huffman h;
  std::memset(&h, 0, sizeof(h));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      h.code[vals[k]] = uint16_t(code++);
      h.size[vals[k]] = uint8_t(len);
    }
    code <<= 1;
  }
  return h;
}

const Huffman kDcLuma = make_huffman(kDcLumaBits, kDcVals);
const Huffman kDcChroma = make_huffman(kDcChromaBits, kDcVals);
const Huffman kAcLuma = make_huffman(kAcLumaBits, kAcLumaVals);
const Huffman kAcChroma = make_huffman(kAcChromaBits, kAcChromaVals);

// the DCT's cosine matrix, A[u][x] = c(u) / 2 * cos((2x + 1) u pi / 16) * 2^13
struct Cosines {
  int m[8][8];
  Cosines() {
    const double pi = 3.14159265358979323846;
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x) {
        const double c = u == 0 ? std::sqrt(0.125) : 0.5 * std::cos((2 * x + 1) * u * pi / 16);
        m[u][x] = int(std::lround(c * 8192.0));
      }
  }
};
const Cosines kCos;

void quant_tables(int quality, int* luma, int* chroma) {
  quality = std::min(std::max(quality, 1), 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int i = 0; i < 64; ++i) {
    luma[i] = std::min(std::max((kLumaQ[i] * scale + 50) / 100, 1), 255);
    chroma[i] = std::min(std::max((kChromaQ[i] * scale + 50) / 100, 1), 255);
  }
}

// The quantiser of one table: the divisor, and floor(2^32 / divisor) + 1,
// whose product with x, shifted down 32, is x / divisor for every x below
// 70,000 (checked for each divisor 1-255), far above a coefficient's range.
struct Quant {
  int q[64];
  uint64_t recip[64];
};

Quant make_quant(const int* table) {
  Quant out;
  for (int i = 0; i < 64; ++i) {
    out.q[i] = table[i];
    out.recip[i] = (uint64_t(1) << 32) / uint64_t(table[i]) + 1;
  }
  return out;
}

// sum_x m[x] * v[x] for one cosine row, by its symmetry about the middle
// (row u is even in x for even u and odd for odd u, exactly so after the
// symmetric rounding): 4 products, equal to the 8-term sum.
inline int dot8(const int* m, const int* sums, const int* diffs, int u) {
  const int* v = (u & 1) ? diffs : sums;
  return m[0] * v[0] + m[1] * v[1] + m[2] * v[2] + m[3] * v[3];
}

// One 8x8 block (level-shifted samples) -> quantised coefficients, natural order.
void forward_block(const int* in, const Quant& q, int* out) {
  int t[64];
  int sums[4], diffs[4];
  for (int y = 0; y < 8; ++y) {
    const int* r = in + y * 8;
    for (int k = 0; k < 4; ++k) {
      sums[k] = r[k] + r[7 - k];
      diffs[k] = r[k] - r[7 - k];
    }
    for (int u = 0; u < 8; ++u) t[y * 8 + u] = (dot8(kCos.m[u], sums, diffs, u) + (1 << 10)) >> 11;
  }
  for (int u = 0; u < 8; ++u) {
    for (int k = 0; k < 4; ++k) {
      sums[k] = t[k * 8 + u] + t[(7 - k) * 8 + u];
      diffs[k] = t[k * 8 + u] - t[(7 - k) * 8 + u];
    }
    for (int v = 0; v < 8; ++v) {
      const int f = (dot8(kCos.m[v], sums, diffs, v) + (1 << 14)) >> 15;
      const int i = v * 8 + u;
      const uint64_t a = uint64_t(f >= 0 ? f : -f) + uint64_t(q.q[i] / 2);
      const int mag = int((a * q.recip[i]) >> 32);
      out[i] = f >= 0 ? mag : -mag;
    }
  }
}

// The frame's planes, padded to whole MCUs: Y (H16, W16), Cb and Cr (H16/2, W16/2).
struct Planes {
  int h16, w16;
  std::vector<int> y, cb, cr;
};

Planes to_planes(const uint8_t* rgb, int h, int w, bool bgr) {
  Planes p;
  p.h16 = (h + 15) / 16 * 16;
  p.w16 = (w + 15) / 16 * 16;
  const int ch = p.h16 / 2, cw = p.w16 / 2;
  p.y.resize(size_t(p.h16) * p.w16);
  p.cb.resize(size_t(ch) * cw);
  p.cr.resize(size_t(ch) * cw);
  const int ri = bgr ? 2 : 0, bi = bgr ? 0 : 2;
  std::vector<int> col(p.w16);  // byte offset of each padded column's pixel
  for (int x = 0; x < p.w16; ++x) col[x] = std::min(x, w - 1) * 3;
  // one pass over each 2x2 group: its four Y, and the rounded mean of its
  // four full-resolution Cb and Cr
  for (int cy = 0; cy < ch; ++cy) {
    const uint8_t* rows[2] = {rgb + size_t(std::min(2 * cy, h - 1)) * w * 3,
                              rgb + size_t(std::min(2 * cy + 1, h - 1)) * w * 3};
    int* ys[2] = {&p.y[size_t(2 * cy) * p.w16], &p.y[size_t(2 * cy + 1) * p.w16]};
    for (int cx = 0; cx < cw; ++cx) {
      int sb = 0, sr = 0;
      for (int dy = 0; dy < 2; ++dy)
        for (int dx = 0; dx < 2; ++dx) {
          const int x = 2 * cx + dx;
          const uint8_t* px = rows[dy] + col[x];
          const int r = px[ri], g = px[1], b = px[bi];
          ys[dy][x] = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
          sb += (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32768) >> 16;
          sr += (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32768) >> 16;
        }
      p.cb[size_t(cy) * cw + cx] = std::min(255, (sb + 2) >> 2);
      p.cr[size_t(cy) * cw + cx] = std::min(255, (sr + 2) >> 2);
    }
  }
  return p;
}

void load_block(const std::vector<int>& plane, int stride, int y0, int x0, int* out) {
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) out[y * 8 + x] = plane[size_t(y0 + y) * stride + x0 + x] - 128;
}

// Every MCU's six blocks (4 Y, Cb, Cr) of quantised coefficients, in scan order.
void forward_frame(const uint8_t* rgb, int h, int w, int quality, bool bgr,
                   std::vector<int>& coefs, int* mcus_y, int* mcus_x) {
  int ql[64], qc[64];
  quant_tables(quality, ql, qc);
  const Quant luma = make_quant(ql), chroma = make_quant(qc);
  const Planes p = to_planes(rgb, h, w, bgr);
  *mcus_y = p.h16 / 16;
  *mcus_x = p.w16 / 16;
  coefs.resize(size_t(*mcus_y) * *mcus_x * 6 * 64);
  int block[64];
  int* out = coefs.data();
  for (int my = 0; my < *mcus_y; ++my)
    for (int mx = 0; mx < *mcus_x; ++mx) {
      for (int k = 0; k < 4; ++k, out += 64) {
        load_block(p.y, p.w16, my * 16 + (k / 2) * 8, mx * 16 + (k % 2) * 8, block);
        forward_block(block, luma, out);
      }
      load_block(p.cb, p.w16 / 2, my * 8, mx * 8, block);
      forward_block(block, chroma, out);
      out += 64;
      load_block(p.cr, p.w16 / 2, my * 8, mx * 8, block);
      forward_block(block, chroma, out);
      out += 64;
    }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int len) {
    acc = (acc << len) | (bits & ((1u << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      const uint8_t byte = uint8_t(acc >> (nbits - 8));
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) put(0x7F, 8 - nbits);  // pad with 1 bits
  }
};

inline int magnitude(int v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
  return n;
}

void encode_block(BitWriter& bw, const int* coef, int& pred, const Huffman& dc, const Huffman& ac) {
  const int diff = coef[0] - pred;
  pred = coef[0];
  int n = magnitude(diff);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(uint32_t(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = coef[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = magnitude(v);
    const int sym = (run << 4) | n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(uint32_t(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.size[0]);
}

void marker(std::vector<uint8_t>& o, uint8_t m, int length) {
  o.push_back(0xFF);
  o.push_back(m);
  if (length >= 0) {
    o.push_back(uint8_t(length >> 8));
    o.push_back(uint8_t(length));
  }
}

void huffman_segment(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  marker(o, 0xC4, 2 + 1 + 16 + n);
  o.push_back(uint8_t(cls_id));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

void encode_frame(const uint8_t* rgb, int h, int w, int quality, bool bgr, std::vector<uint8_t>& o) {
  std::vector<int> coefs;
  int my, mx;
  forward_frame(rgb, h, w, quality, bgr, coefs, &my, &mx);
  int ql[64], qc[64];
  quant_tables(quality, ql, qc);
  o.clear();
  o.reserve(size_t(h) * w / 2);
  marker(o, 0xD8, -1);  // SOI
  const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  marker(o, 0xE0, 2 + sizeof(jfif));
  o.insert(o.end(), jfif, jfif + sizeof(jfif));
  marker(o, 0xDB, 2 + 2 * 65);  // DQT, both tables in zigzag order
  o.push_back(0);
  for (int k = 0; k < 64; ++k) o.push_back(uint8_t(ql[kZigzag[k]]));
  o.push_back(1);
  for (int k = 0; k < 64; ++k) o.push_back(uint8_t(qc[kZigzag[k]]));
  marker(o, 0xC0, 2 + 6 + 3 * 3);  // SOF0
  const uint8_t sof[] = {8, uint8_t(h >> 8), uint8_t(h), uint8_t(w >> 8), uint8_t(w), 3,
                         1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), sof, sof + sizeof(sof));
  huffman_segment(o, 0x00, kDcLumaBits, kDcVals);
  huffman_segment(o, 0x10, kAcLumaBits, kAcLumaVals);
  huffman_segment(o, 0x01, kDcChromaBits, kDcVals);
  huffman_segment(o, 0x11, kAcChromaBits, kAcChromaVals);
  marker(o, 0xDA, 2 + 1 + 3 * 2 + 3);  // SOS
  const uint8_t sos[] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), sos, sos + sizeof(sos));
  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  const int* c = coefs.data();
  for (int m = 0; m < my * mx; ++m) {
    for (int k = 0; k < 4; ++k, c += 64) encode_block(bw, c, pred[0], kDcLuma, kAcLuma);
    encode_block(bw, c, pred[1], kDcChroma, kAcChroma);
    c += 64;
    encode_block(bw, c, pred[2], kDcChroma, kAcChroma);
    c += 64;
  }
  bw.flush();
  marker(o, 0xD9, -1);  // EOI
}

}  // namespace

extern "C" {

// Encode n (h, w, 3) frames; frame i's JPEG goes to out at the sum of the
// sizes before it, its length to sizes[i]. Returns 1, with every size set,
// when the JPEGs do not fit in capacity bytes (nothing is copied then).
int m2de_jpeg_encode_block(const uint8_t* frames, int n, int h, int w, int quality, int bgr,
                           int threads, uint8_t* out, int64_t capacity, int64_t* sizes) {
  if (n < 0 || h <= 0 || w <= 0 || h > 65535 || w > 65535) return 2;
  std::vector<std::vector<uint8_t>> jpegs(n);
  threads = std::max(1, std::min(threads, n));
  auto work = [&](int t) {
    for (int i = t; i < n; i += threads)
      encode_frame(frames + size_t(i) * h * w * 3, h, w, quality, bgr != 0, jpegs[i]);
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& th : pool) th.join();
  int64_t total = 0;
  for (int i = 0; i < n; ++i) total += int64_t(sizes[i] = int64_t(jpegs[i].size()));
  if (total > capacity) return 1;
  for (int i = 0; i < n; ++i) {
    std::memcpy(out, jpegs[i].data(), jpegs[i].size());
    out += jpegs[i].size();
  }
  return 0;
}

// One frame's quantised coefficients: (mcus, 6, 64) in natural order.
int m2de_jpeg_forward(const uint8_t* frame, int h, int w, int quality, int bgr, int32_t* out) {
  std::vector<int> coefs;
  int my, mx;
  forward_frame(frame, h, w, quality, bgr != 0, coefs, &my, &mx);
  for (size_t i = 0; i < coefs.size(); ++i) out[i] = coefs[i];
  return 0;
}
}
