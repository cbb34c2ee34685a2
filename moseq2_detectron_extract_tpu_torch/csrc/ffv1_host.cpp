// FFV1 version 3 (RFC 9043), gray16 with the range coder: decoder and
// encoder on the host.
//
// The decoder reads what libavcodec writes for gray16le: the configuration
// record in the extradata (quant tables, state-transition table, context
// counts, ec), frames whose slices are found from the end backwards through
// each slice's trailing size, a CRC per slice when ec is set, and
// non-keyframes that carry each slice's adapted context states over from the
// frame before. The slices of a batch of frames are decoded on several
// threads: slice s of frame f + 1 depends only on slice s of frame f, so
// each thread takes a set of slice positions through the whole batch.
//
// The encoder writes version 3 with the custom state-transition table,
// context model 0 (three-input contexts), the slice grid asked for, slice
// CRCs and a keyframe every `gop` frames.
//
// Samples follow libavcodec's 16-bit rules (RFC 9043 section 3.3): they are
// held as two's-complement int16, so the median predictor and the residual
// work on signed values, and a residual is folded into 16 bits.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int CONTEXT_SIZE = 32;
constexpr int MAX_QUANT_TABLES = 8;
constexpr int MAX_SLICES = 1024;

// Error codes (negative); a slice error reports its frame and slice.
enum {
  ERR_CONFIG = -1,        // malformed configuration record
  ERR_CONFIG_CRC = -2,    // configuration record CRC mismatch
  ERR_VERSION = -3,       // unsupported version (detail: the version)
  ERR_FORMAT = -4,        // not gray16 (detail: colorspace * 1000 + bits, or 100000 + coder)
  ERR_NO_KEYFRAME = -5,   // a non-keyframe without a decoded keyframe before it
  ERR_SLICES = -6,        // slice chain broken or slice count changed
  ERR_SLICE_CRC = -7,     // slice CRC mismatch
  ERR_SLICE_HEADER = -8,  // bad slice header
  ERR_SLICE_END = -9,     // slice payload does not end where its size says
  ERR_SLICE_STATUS = -10, // the encoder marked the slice as damaged
};

uint32_t CRC_TABLE[256];

void init_crc() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i << 24;
    for (int j = 0; j < 8; j++) c = (c << 1) ^ ((c & 0x80000000u) ? 0x04C11DB7u : 0);
    CRC_TABLE[i] = c;
  }
}

// CRC-32, polynomial 0x04C11DB7, MSB first, no reflection, no final xor.
uint32_t crc32(uint32_t crc, const uint8_t *p, int64_t n) {
  for (int64_t i = 0; i < n; i++) crc = (crc << 8) ^ CRC_TABLE[(crc >> 24) ^ p[i]];
  return crc;
}

struct StateTables {
  uint8_t zero[256];
  uint8_t one[256];
};

// The range coder's default transition table (libavcodec's
// ff_build_rac_states with factor 0.05 * 2^32 and max_p 248).
StateTables default_states() {
  StateTables t;
  std::memset(&t, 0, sizeof(t));
  const int64_t one = 1LL << 32;
  const int64_t factor = (int64_t)(0.05 * (double)(1LL << 32));
  const int max_p = 256 - 8;
  int64_t p = one / 2;
  int last_p8 = 0;
  for (int i = 0; i < 128; i++) {
    int p8 = (int)((256 * p + one / 2) >> 32);
    if (p8 <= last_p8) p8 = last_p8 + 1;
    if (last_p8 && last_p8 < 256 && p8 <= max_p) t.one[last_p8] = (uint8_t)p8;
    p += ((one - p) * factor + one / 2) >> 32;
    last_p8 = p8;
  }
  for (int i = 256 - max_p; i <= max_p; i++) {
    if (t.one[i]) continue;
    p = ((int64_t)i * one + 128) >> 8;
    p += ((one - p) * factor + one / 2) >> 32;
    int p8 = (int)((256 * p + one / 2) >> 32);
    if (p8 <= i) p8 = i + 1;
    if (p8 > max_p) p8 = max_p;
    t.one[i] = (uint8_t)p8;
  }
  for (int i = 1; i < 255; i++) t.zero[i] = (uint8_t)(256 - t.one[256 - i]);
  return t;
}

StateTables custom_states(const uint8_t *transition) {
  StateTables t = default_states();
  for (int i = 1; i < 256; i++) {
    t.one[i] = transition[i];
    t.zero[256 - i] = (uint8_t)(256 - transition[i]);
  }
  return t;
}

// ---------------------------------------------------------------------------
// range decoder

struct RangeDecoder {
  const uint8_t *p, *end;
  uint32_t low, range;
  int overread;
  const StateTables *tab;

  void init(const uint8_t *buf, int64_t size, const StateTables *t) {
    tab = t;
    p = buf;
    end = buf + size;
    low = size >= 2 ? (uint32_t(buf[0]) << 8 | buf[1]) : 0;
    p += 2;
    range = 0xFF00;
    overread = 0;
    if (low >= 0xFF00) {
      low = 0xFF00;
      end = p;
    }
  }
  inline void refill() {
    if (range < 0x100) {
      range <<= 8;
      low <<= 8;
      if (p < end) low += *p;
      else overread++;
      p++;
    }
  }
  inline int bit(uint8_t *state) {
    uint32_t r1 = (range * *state) >> 8;
    range -= r1;
    if (low < range) {
      *state = tab->zero[*state];
      refill();
      return 0;
    }
    low -= range;
    *state = tab->one[*state];
    range = r1;
    refill();
    return 1;
  }
  inline int symbol(uint8_t *state, bool is_signed) {
    if (bit(state)) return 0;
    int e = 0;
    while (bit(state + 1 + std::min(e, 9))) {
      if (++e > 31) return 0;
    }
    uint32_t a = 1;
    for (int i = e - 1; i >= 0; i--) a += a + bit(state + 22 + std::min(i, 9));
    int neg = is_signed && bit(state + 11 + std::min(e, 10));
    return neg ? -(int)a : (int)a;
  }
  // bytes consumed so far, the read-ahead included
  int64_t consumed(const uint8_t *start) const { return p - start; }
};

// ---------------------------------------------------------------------------
// range encoder (carries propagate into the bytes already written)

struct RangeEncoder {
  std::vector<uint8_t> *out;
  int64_t start;
  uint32_t low, range;
  const StateTables *tab;

  void init(std::vector<uint8_t> *o, const StateTables *t) {
    out = o;
    start = (int64_t)o->size();
    low = 0;
    range = 0xFF00;
    tab = t;
  }
  inline void carry() {
    int64_t i = (int64_t)out->size() - 1;
    while (i >= start && (*out)[i] == 0xFF) (*out)[i--] = 0;
    if (i >= start) (*out)[i]++;
  }
  inline void shift() {
    if (low >= 0x10000) {
      carry();
      low -= 0x10000;
    }
    out->push_back((uint8_t)(low >> 8));
    low = (low & 0xFF) << 8;
    range <<= 8;
  }
  inline void bit(uint8_t *state, int b) {
    uint32_t r1 = (range * *state) >> 8;
    if (!b) {
      range -= r1;
      *state = tab->zero[*state];
    } else {
      low += range - r1;
      range = r1;
      *state = tab->one[*state];
    }
    while (range < 0x100) shift();
  }
  inline void symbol(uint8_t *state, int v, bool is_signed) {
    if (!v) {
      bit(state, 1);
      return;
    }
    const uint32_t a = (uint32_t)(v < 0 ? -v : v);
    int e = 31 - __builtin_clz(a);
    bit(state, 0);
    for (int i = 0; i < e; i++) bit(state + 1 + std::min(i, 9), 1);
    bit(state + 1 + std::min(e, 9), 0);
    for (int i = e - 1; i >= 0; i--) bit(state + 22 + std::min(i, 9), (a >> i) & 1);
    if (is_signed) bit(state + 11 + std::min(e, 10), v < 0);
  }
  // Ends the stream so that a decoder that has read `shifts + 2` bytes sees
  // a value inside the interval, where the byte after the written ones is
  // `next` (the first byte of what follows the payload).
  void finish(uint8_t next) {
    low += (next - (low & 0xFF)) & 0xFF;
    if (low >= 0x10000) {
      carry();
      low -= 0x10000;
    }
    out->push_back((uint8_t)(low >> 8));
  }
  int64_t shifts_written() const { return (int64_t)out->size() - start; }
};

// ---------------------------------------------------------------------------
// configuration

struct Config {
  int version = 0, micro_version = 0, coder = 0, colorspace = 0, bits = 0;
  int chroma_planes = 0, h_shift = 0, v_shift = 0, transparency = 0;
  int num_h = 1, num_v = 1, quant_table_count = 0, ec = 0, intra = 0;
  int plane_count = 0;
  uint32_t crcref = 0;
  uint8_t transition[256];
  int16_t quant[MAX_QUANT_TABLES][5][256];
  int context_count[MAX_QUANT_TABLES];
  std::vector<uint8_t> initial[MAX_QUANT_TABLES];  // context_count * 32
  StateTables header_tab, slice_tab;
};

int read_quant_table(RangeDecoder &c, int16_t *table, int scale) {
  uint8_t state[CONTEXT_SIZE];
  std::memset(state, 128, sizeof(state));
  int i = 0, v = 0;
  for (v = 0; i < 128; v++) {
    unsigned len = (unsigned)c.symbol(state, false) + 1u;
    if (len > (unsigned)(128 - i) || !len) return -1;
    while (len--) table[i++] = (int16_t)(scale * v);
  }
  for (i = 1; i < 128; i++) table[256 - i] = (int16_t)-table[i];
  table[128] = (int16_t)-table[127];
  return 2 * v - 1;
}

int parse_config(const uint8_t *extra, int64_t size, Config &cfg, int *detail) {
  init_crc();
  if (size < 4) return ERR_CONFIG;
  cfg.header_tab = default_states();
  RangeDecoder c;
  c.init(extra, size, &cfg.header_tab);
  uint8_t state[CONTEXT_SIZE];
  std::memset(state, 128, sizeof(state));
  cfg.version = c.symbol(state, false);
  *detail = cfg.version;
  if (cfg.version != 3) return ERR_VERSION;
  c.end -= 4;
  cfg.micro_version = c.symbol(state, false);
  cfg.coder = c.symbol(state, false);
  if (cfg.coder == 2) {
    for (int i = 1; i < 256; i++)
      cfg.transition[i] = (uint8_t)(c.symbol(state, true) + cfg.header_tab.one[i]);
  } else {
    for (int i = 1; i < 256; i++) cfg.transition[i] = cfg.header_tab.one[i];
  }
  cfg.colorspace = c.symbol(state, false);
  cfg.bits = c.symbol(state, false);
  cfg.chroma_planes = c.bit(state);
  cfg.h_shift = c.symbol(state, false);
  cfg.v_shift = c.symbol(state, false);
  cfg.transparency = c.bit(state);
  cfg.num_h = 1 + c.symbol(state, false);
  cfg.num_v = 1 + c.symbol(state, false);
  cfg.plane_count = 1 + 1 + cfg.transparency;  // version < 4: two planes counted
  if (cfg.num_h <= 0 || cfg.num_v <= 0 || cfg.num_h * cfg.num_v > MAX_SLICES) return ERR_CONFIG;
  cfg.quant_table_count = c.symbol(state, false);
  if (cfg.quant_table_count <= 0 || cfg.quant_table_count > MAX_QUANT_TABLES) return ERR_CONFIG;
  for (int t = 0; t < cfg.quant_table_count; t++) {
    int count = 1;
    for (int k = 0; k < 5; k++) {
      int r = read_quant_table(c, cfg.quant[t][k], count);
      if (r < 0) return ERR_CONFIG;
      count *= r;
      if (count > 32768) return ERR_CONFIG;
    }
    cfg.context_count[t] = (count + 1) / 2;
    cfg.initial[t].assign((size_t)cfg.context_count[t] * CONTEXT_SIZE, 128);
  }
  uint8_t state2[CONTEXT_SIZE][CONTEXT_SIZE];
  std::memset(state2, 128, sizeof(state2));
  for (int t = 0; t < cfg.quant_table_count; t++) {
    if (c.bit(state)) {
      uint8_t *init = cfg.initial[t].data();
      for (int j = 0; j < cfg.context_count[t]; j++)
        for (int k = 0; k < CONTEXT_SIZE; k++) {
          int pred = j ? init[(j - 1) * CONTEXT_SIZE + k] : 128;
          init[j * CONTEXT_SIZE + k] = (uint8_t)((pred + c.symbol(state2[k], true)) & 0xFF);
        }
    }
  }
  cfg.ec = c.symbol(state, false);
  if (cfg.micro_version >= 3) cfg.intra = c.symbol(state, false);
  cfg.crcref = cfg.ec >= 2 ? 0x7a8c4079u : 0;
  if (crc32(cfg.crcref, extra, size) != cfg.crcref) return ERR_CONFIG_CRC;
  if (cfg.coder != 1 && cfg.coder != 2) {
    *detail = 100000 + cfg.coder;
    return ERR_FORMAT;
  }
  if (cfg.colorspace != 0 || cfg.chroma_planes || cfg.transparency || cfg.bits != 16) {
    *detail = cfg.colorspace * 1000 + cfg.bits;
    return ERR_FORMAT;
  }
  cfg.slice_tab = cfg.coder == 2 ? custom_states(cfg.transition) : default_states();
  return 0;
}

inline int mid_pred(int a, int b, int c) {
  if (a > b) std::swap(a, b);
  return std::max(a, std::min(b, c));
}

// The context of the sample at x from its neighbours: cur[x-2], cur[x-1]
// (left), prev[x-1], prev[x], prev[x+1] and prev2[x].
inline int get_context(const int16_t (*q)[256], bool five, const int16_t *cur,
                       const int16_t *prev, const int16_t *prev2, int x) {
  const int LT = prev[x - 1], T = prev[x], RT = prev[x + 1], L = cur[x - 1];
  int ctx = q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] + q[2][(T - RT) & 0xFF];
  if (five) ctx += q[3][(cur[x - 2] - L) & 0xFF] + q[4][(prev2[x] - T) & 0xFF];
  return ctx;
}

inline int predict(const int16_t *cur, const int16_t *prev, int x) {
  const int LT = prev[x - 1], T = prev[x], L = cur[x - 1];
  return mid_pred(L, L + T - LT, T);
}

// Row buffers of one slice: three rows of w + 6 samples, 3 of padding on
// the left; rotated so that prev2 is the row two above.
struct Rows {
  std::vector<int16_t> buf;
  int w = 0;
  int16_t *row[3];
  void reset(int width) {
    w = width;
    buf.assign((size_t)3 * (w + 6), 0);
    for (int i = 0; i < 3; i++) row[i] = buf.data() + i * (w + 6) + 3;
  }
  // before row y: row[0] becomes the current row, row[1] the one above
  void advance() {
    int16_t *oldest = row[2];
    row[2] = row[1];
    row[1] = row[0];
    row[0] = oldest;
    row[0][-1] = row[1][0];
    row[1][w] = row[1][w - 1];
  }
};

struct SliceState {
  int qt = -1;                 // quant table of plane 0
  std::vector<uint8_t> state;  // context_count * 32
  bool valid = false;
};

struct SliceLoc {
  const uint8_t *start;
  int64_t size;  // the payload and its trailer
};

struct FramePlan {
  const uint8_t *data;
  int64_t size;
  bool key;
  std::vector<SliceLoc> slices;  // in frame order
  uint16_t *out;
};

int locate_slices(const Config &cfg, const uint8_t *buf, int64_t size, std::vector<SliceLoc> &out) {
  const int trailer = 3 + 5 * (cfg.ec ? 1 : 0);
  out.clear();
  const uint8_t *p = buf + size;
  while (p - buf > trailer && (int)out.size() < MAX_SLICES) {
    int64_t v = ((int64_t)p[-trailer] << 16 | (int64_t)p[-trailer + 1] << 8 | p[-trailer + 2]) + trailer;
    if (v > p - buf) return ERR_SLICES;
    p -= v;
    out.push_back({p, v});
  }
  if (p != buf || out.empty()) return ERR_SLICES;
  std::reverse(out.begin(), out.end());
  return 0;
}

struct SliceError {
  int64_t frame = -1;
  int slice = -1;
  int code = 0;
};

// Decodes slice `s` of a frame into `out` (width x height, row stride
// `width`), carrying the slice's states in `ss`.
int decode_slice(const Config &cfg, const FramePlan &fp, int s, SliceState &ss, Rows &rows,
                 int width, int height, uint16_t *out) {
  const SliceLoc &loc = fp.slices[s];
  if (cfg.ec) {
    if (crc32(cfg.crcref, loc.start, loc.size) != cfg.crcref) return ERR_SLICE_CRC;
    if (loc.start[loc.size - 5] != 0) return ERR_SLICE_STATUS;
  }
  RangeDecoder c;
  c.init(loc.start, loc.size, &cfg.slice_tab);
  if (s == 0) {
    uint8_t keystate = 128;
    c.bit(&keystate);
  }
  uint8_t hs[CONTEXT_SIZE];
  std::memset(hs, 128, sizeof(hs));
  const unsigned sx = (unsigned)c.symbol(hs, false), sy = (unsigned)c.symbol(hs, false);
  const unsigned sw = (unsigned)c.symbol(hs, false) + 1u, sh = (unsigned)c.symbol(hs, false) + 1u;
  if (sx + sw > (unsigned)cfg.num_h || sy + sh > (unsigned)cfg.num_v) return ERR_SLICE_HEADER;
  int qt0 = -1;
  for (int i = 0; i < cfg.plane_count; i++) {
    int idx = c.symbol(hs, false);
    if (idx < 0 || idx >= cfg.quant_table_count) return ERR_SLICE_HEADER;
    if (i == 0) qt0 = idx;
  }
  c.symbol(hs, false);  // picture structure
  c.symbol(hs, false);  // sample aspect ratio
  c.symbol(hs, false);
  const int x0 = (int)((int64_t)width * sx / cfg.num_h);
  const int y0 = (int)((int64_t)height * sy / cfg.num_v);
  const int w = (int)((int64_t)width * (sx + sw) / cfg.num_h) - x0;
  const int h = (int)((int64_t)height * (sy + sh) / cfg.num_v) - y0;
  if (w <= 0 || h <= 0) return ERR_SLICE_HEADER;
  if (fp.key) {
    ss.qt = qt0;
    ss.state = cfg.initial[qt0];
    ss.valid = true;
  } else if (!ss.valid || ss.qt != qt0) {
    return ERR_NO_KEYFRAME;
  }
  const int16_t (*q)[256] = cfg.quant[qt0];
  const bool five = q[3][127] || q[4][127];
  uint8_t *states = ss.state.data();
  rows.reset(w);
  for (int y = 0; y < h; y++) {
    rows.advance();
    int16_t *cur = rows.row[0];
    const int16_t *prev = rows.row[1], *prev2 = rows.row[2];
    uint16_t *dst = out + (int64_t)(y0 + y) * width + x0;
    for (int x = 0; x < w; x++) {
      int ctx = get_context(q, five, cur, prev, prev2, x);
      int diff;
      if (ctx < 0) {
        diff = -c.symbol(states + (int64_t)(-ctx) * CONTEXT_SIZE, true);
      } else {
        diff = c.symbol(states + (int64_t)ctx * CONTEXT_SIZE, true);
      }
      const uint16_t v = (uint16_t)(predict(cur, prev, x) + diff);
      cur[x] = (int16_t)v;
      dst[x] = v;
    }
    if (c.overread > 8) return ERR_SLICE_END;
  }
  uint8_t end_state = 129;
  c.bit(&end_state);
  if (loc.size - c.consumed(loc.start) != 2 + 5 * (cfg.ec ? 1 : 0)) return ERR_SLICE_END;
  return 0;
}

struct Decoder {
  Config cfg;
  int width = 0, height = 0;
  std::vector<SliceState> slices;
  std::vector<uint16_t> scratch;
};

// ---------------------------------------------------------------------------
// encoder

// The tables the encoder writes into its configuration record: the first
// half of libavcodec's quant table for samples of more than 8 bits (each of
// the three context inputs uses it, scaled by 1, 9 and 81), and libavcodec's
// custom state-transition table. Both as a libavcodec 62 configuration
// record for gray16 holds them.
const int8_t QUANT9_10BIT[128] = {
    0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3,
    3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
};
const uint8_t VER2_STATE[256] = {
    0, 10, 10, 10, 10, 16, 16, 16, 28, 16, 16, 29, 42, 49, 20, 49, 59, 25, 26, 26, 27, 31, 33, 33,
    33, 34, 34, 37, 67, 38, 39, 39, 40, 40, 41, 79, 43, 44, 45, 45, 48, 48, 64, 50, 51, 52, 88, 52,
    53, 74, 55, 57, 58, 58, 74, 60, 101, 61, 62, 84, 66, 66, 68, 69, 87, 82, 71, 97, 73, 73, 82, 75,
    111, 77, 94, 78, 87, 81, 83, 97, 85, 83, 94, 86, 99, 89, 90, 99, 111, 92, 93, 134, 95, 98, 105, 98,
    105, 110, 102, 108, 102, 118, 103, 106, 106, 113, 109, 112, 114, 112, 116, 125, 115, 116, 117, 117, 126, 119, 125, 121,
    121, 123, 145, 124, 126, 131, 127, 129, 165, 130, 132, 138, 133, 135, 145, 136, 137, 139, 146, 141, 143, 142, 144, 148,
    147, 155, 151, 149, 151, 150, 152, 157, 153, 154, 156, 168, 158, 162, 161, 160, 172, 163, 169, 164, 166, 184, 167, 170,
    177, 174, 171, 173, 182, 176, 180, 178, 175, 189, 179, 181, 186, 183, 192, 185, 200, 187, 191, 188, 190, 197, 193, 196,
    197, 194, 195, 196, 198, 202, 199, 201, 210, 203, 207, 204, 205, 206, 208, 214, 209, 211, 221, 212, 213, 215, 224, 216,
    217, 218, 219, 220, 222, 228, 223, 225, 226, 224, 227, 229, 240, 230, 231, 232, 233, 234, 235, 236, 238, 239, 237, 242,
    241, 243, 242, 244, 245, 246, 247, 248, 249, 250, 251, 252, 252, 253, 254, 255,
};

struct SliceRect {
  int sx, sy, x0, y0, w, h;
};

struct Encoder {
  Config cfg;
  int width = 0, height = 0, gop = 12;
  int64_t frame_number = 0;
  std::vector<SliceRect> rects;
  std::vector<SliceState> slices;
  std::vector<uint8_t> extradata;
  std::vector<uint8_t> packets;  // the last batch, frames back to back
  std::vector<int64_t> sizes;
  std::vector<uint8_t> keys;
};

void write_quant_table(RangeEncoder &c, const int16_t *table) {
  uint8_t state[CONTEXT_SIZE];
  std::memset(state, 128, sizeof(state));
  int last = 0, i;
  for (i = 1; i < 128; i++)
    if (table[i] != table[i - 1]) {
      c.symbol(state, i - last - 1, false);
      last = i;
    }
  c.symbol(state, i - last - 1, false);
}

void build_encoder_config(Encoder &e, int num_h, int num_v, int ec) {
  Config &cfg = e.cfg;
  cfg.version = 3;
  cfg.micro_version = 4;
  cfg.coder = 2;
  cfg.colorspace = 0;
  cfg.bits = 16;
  cfg.num_h = num_h;
  cfg.num_v = num_v;
  cfg.plane_count = 2;
  cfg.quant_table_count = 1;
  cfg.ec = ec;
  cfg.intra = 0;
  std::memset(cfg.quant, 0, sizeof(cfg.quant));
  for (int i = 0; i < 128; i++) {
    cfg.quant[0][0][i] = QUANT9_10BIT[i];
    cfg.quant[0][1][i] = (int16_t)(9 * QUANT9_10BIT[i]);
    cfg.quant[0][2][i] = (int16_t)(81 * QUANT9_10BIT[i]);
  }
  for (int k = 0; k < 3; k++) {
    for (int i = 1; i < 128; i++) cfg.quant[0][k][256 - i] = (int16_t)-cfg.quant[0][k][i];
    cfg.quant[0][k][128] = (int16_t)-cfg.quant[0][k][127];
  }
  cfg.context_count[0] = (9 * 9 * 9 + 1) / 2;
  cfg.initial[0].assign((size_t)cfg.context_count[0] * CONTEXT_SIZE, 128);
  for (int i = 0; i < 256; i++) cfg.transition[i] = VER2_STATE[i];
  cfg.header_tab = default_states();
  cfg.slice_tab = custom_states(cfg.transition);

  std::vector<uint8_t> &x = e.extradata;
  x.clear();
  RangeEncoder c;
  c.init(&x, &cfg.header_tab);
  uint8_t state[CONTEXT_SIZE];
  std::memset(state, 128, sizeof(state));
  c.symbol(state, cfg.version, false);
  c.symbol(state, cfg.micro_version, false);
  c.symbol(state, cfg.coder, false);
  for (int i = 1; i < 256; i++) c.symbol(state, cfg.transition[i] - cfg.header_tab.one[i], true);
  c.symbol(state, cfg.colorspace, false);
  c.symbol(state, cfg.bits, false);
  c.bit(state, 0);  // chroma planes
  c.symbol(state, 0, false);
  c.symbol(state, 0, false);
  c.bit(state, 0);  // transparency
  c.symbol(state, cfg.num_h - 1, false);
  c.symbol(state, cfg.num_v - 1, false);
  c.symbol(state, cfg.quant_table_count, false);
  for (int k = 0; k < 5; k++) write_quant_table(c, cfg.quant[0][k]);
  c.bit(state, 0);  // initial states not coded
  c.symbol(state, cfg.ec, false);
  c.symbol(state, cfg.intra, false);
  c.finish(0);
  const uint32_t crc = crc32(0, x.data(), (int64_t)x.size());
  for (int k = 3; k >= 0; k--) x.push_back((uint8_t)(crc >> (8 * k)));
}

// Encodes slice `s` of a frame into `out`: payload, 24-bit size, and with
// ec a zero status byte and the CRC.
void encode_slice(const Encoder &e, const uint16_t *frame, int s, bool key, SliceState &ss,
                  Rows &rows, std::vector<uint8_t> &out) {
  const Config &cfg = e.cfg;
  const SliceRect &r = e.rects[s];
  out.clear();
  RangeEncoder c;
  c.init(&out, &cfg.slice_tab);
  if (s == 0) {
    uint8_t keystate = 128;
    c.bit(&keystate, key ? 1 : 0);
  }
  if (key) {
    ss.qt = 0;
    ss.state = cfg.initial[0];
    ss.valid = true;
  }
  uint8_t hs[CONTEXT_SIZE];
  std::memset(hs, 128, sizeof(hs));
  c.symbol(hs, r.sx, false);
  c.symbol(hs, r.sy, false);
  c.symbol(hs, 0, false);
  c.symbol(hs, 0, false);
  for (int i = 0; i < cfg.plane_count; i++) c.symbol(hs, 0, false);
  c.symbol(hs, 0, false);  // progressive
  c.symbol(hs, 0, false);  // sample aspect ratio unknown
  c.symbol(hs, 0, false);
  const int16_t (*q)[256] = cfg.quant[0];
  uint8_t *states = ss.state.data();
  rows.reset(r.w);
  for (int y = 0; y < r.h; y++) {
    rows.advance();
    int16_t *cur = rows.row[0];
    const int16_t *prev = rows.row[1], *prev2 = rows.row[2];
    const uint16_t *src = frame + (int64_t)(r.y0 + y) * e.width + r.x0;
    for (int x = 0; x < r.w; x++) cur[x] = (int16_t)src[x];
    for (int x = 0; x < r.w; x++) {
      int ctx = get_context(q, false, cur, prev, prev2, x);
      int diff = (int16_t)(uint16_t)(cur[x] - predict(cur, prev, x));
      if (ctx < 0) {
        ctx = -ctx;
        diff = (int16_t)(uint16_t)(-diff);
      }
      c.symbol(states + (int64_t)ctx * CONTEXT_SIZE, diff, true);
    }
  }
  uint8_t end_state = 129;
  c.bit(&end_state, 0);
  // the decoder has then read the payload and the first byte of the size
  const int64_t bytes = c.shifts_written() + 1;
  c.finish((uint8_t)(bytes >> 16));
  out.push_back((uint8_t)(bytes >> 16));
  out.push_back((uint8_t)(bytes >> 8));
  out.push_back((uint8_t)bytes);
  if (cfg.ec) {
    out.push_back(0);
    const uint32_t crc = crc32(0, out.data(), (int64_t)out.size());
    for (int k = 3; k >= 0; k--) out.push_back((uint8_t)(crc >> (8 * k)));
  }
}

template <typename Fn>
void run_threads(int nthreads, Fn fn) {
  if (nthreads <= 1) {
    fn(0);
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; t++) pool.emplace_back(fn, t);
  for (auto &th : pool) th.join();
}

}  // namespace

extern "C" {

// Parses a configuration record. info: version, micro_version, coder,
// colorspace, bits, num_h, num_v, ec, intra, quant_table_count,
// context_count[0]. Returns 0 or an error code; *detail names the version
// or format refused.
int m2de_ffv1_parse_config(const uint8_t *extra, int64_t size, int32_t *info, int32_t *detail) {
  Config cfg;
  int d = 0;
  int rc = parse_config(extra, size, cfg, &d);
  *detail = d;
  info[0] = cfg.version;
  info[1] = cfg.micro_version;
  info[2] = cfg.coder;
  info[3] = cfg.colorspace;
  info[4] = cfg.bits;
  info[5] = cfg.num_h;
  info[6] = cfg.num_v;
  info[7] = cfg.ec;
  info[8] = cfg.intra;
  info[9] = cfg.quant_table_count;
  info[10] = cfg.quant_table_count > 0 ? cfg.context_count[0] : 0;
  return rc;
}

// Version of a stream without a configuration record (versions 0-1 carry
// theirs in each keyframe): the first symbol after the keyframe bit.
int m2de_ffv1_inline_version(const uint8_t *pkt, int64_t size) {
  StateTables tab = default_states();
  RangeDecoder c;
  c.init(pkt, size, &tab);
  uint8_t keystate = 128;
  if (!c.bit(&keystate)) return -1;
  uint8_t state[CONTEXT_SIZE];
  std::memset(state, 128, sizeof(state));
  return c.symbol(state, false);
}

void *m2de_ffv1_decoder_new(const uint8_t *extra, int64_t size, int width, int height,
                            int32_t *err, int32_t *detail) {
  Decoder *d = new Decoder();
  int dt = 0;
  *err = parse_config(extra, size, d->cfg, &dt);
  *detail = dt;
  if (*err) {
    delete d;
    return nullptr;
  }
  d->width = width;
  d->height = height;
  return d;
}

void m2de_ffv1_decoder_free(void *dec) { delete static_cast<Decoder *>(dec); }

// Decodes n packets in stream order, each to outs[i] (a width x height
// uint16 frame, or null to decode without keeping it), the slices on up to
// `threads` threads. The first packet must be a keyframe unless it follows
// the last packet of the previous call. Returns 0, or an error code with
// *err_frame (index into the batch) and *err_slice (-1 for the frame).
int m2de_ffv1_decode(void *dec, const uint8_t *const *pkts, const int64_t *sizes, int n,
                     uint16_t *const *outs, int threads, int64_t *err_frame, int32_t *err_slice) {
  Decoder &d = *static_cast<Decoder *>(dec);
  const Config &cfg = d.cfg;
  *err_frame = -1;
  *err_slice = -1;
  std::vector<FramePlan> plans(n);
  size_t nslices = 0;
  bool need_scratch = false;
  for (int f = 0; f < n; f++) {
    FramePlan &fp = plans[f];
    fp.data = pkts[f];
    fp.size = sizes[f];
    fp.out = outs[f];
    need_scratch |= fp.out == nullptr;
    if (fp.size < 2) {
      *err_frame = f;
      return ERR_SLICES;
    }
    RangeDecoder c;
    c.init(fp.data, fp.size, &cfg.header_tab);
    uint8_t keystate = 128;
    fp.key = c.bit(&keystate) != 0;
    int rc = locate_slices(cfg, fp.data, fp.size, fp.slices);
    if (rc) {
      *err_frame = f;
      return rc;
    }
    if (f == 0) nslices = fp.slices.size();
    if (!fp.key && f == 0 && d.slices.size() != nslices) {
      *err_frame = f;
      return d.slices.empty() ? ERR_NO_KEYFRAME : ERR_SLICES;
    }
    if (fp.slices.size() != nslices) {  // the slice grid of a batch stays
      *err_frame = f;
      return ERR_SLICES;
    }
  }
  if (n == 0) return 0;
  if (plans[0].key) d.slices.assign(nslices, SliceState());
  if (need_scratch) d.scratch.resize((size_t)d.width * d.height);
  const int nthreads = std::max(1, std::min<int>(threads, (int)nslices));
  std::vector<SliceError> errors(nthreads);
  run_threads(nthreads, [&](int t) {
    Rows rows;
    for (size_t s = t; s < nslices; s += nthreads) {
      for (int f = 0; f < n; f++) {
        uint16_t *out = plans[f].out ? plans[f].out : d.scratch.data();
        int rc = decode_slice(cfg, plans[f], (int)s, d.slices[s], rows, d.width, d.height, out);
        if (rc) {
          if (errors[t].frame < 0 || f < errors[t].frame) errors[t] = {f, (int)s, rc};
          d.slices[s].valid = false;
          break;
        }
      }
    }
  });
  int rc = 0;
  for (const SliceError &e : errors) {
    if (e.code && (*err_frame < 0 || e.frame < *err_frame)) {
      *err_frame = e.frame;
      *err_slice = e.slice;
      rc = e.code;
    }
  }
  return rc;
}

// A new encoder of width x height frames in a grid of num_h x num_v slices,
// a keyframe every `gop` frames, slice CRCs when ec is 1.
void *m2de_ffv1_encoder_new(int width, int height, int num_h, int num_v, int gop, int ec) {
  if (width <= 0 || height <= 0 || num_h <= 0 || num_v <= 0 || num_h > width ||
      num_v > height || gop <= 0 || num_h * num_v > MAX_SLICES)
    return nullptr;
  init_crc();
  Encoder *e = new Encoder();
  e->width = width;
  e->height = height;
  e->gop = gop;
  build_encoder_config(*e, num_h, num_v, ec ? 1 : 0);
  for (int sy = 0; sy < num_v; sy++)
    for (int sx = 0; sx < num_h; sx++) {
      SliceRect r;
      r.sx = sx;
      r.sy = sy;
      r.x0 = (int)((int64_t)width * sx / num_h);
      r.y0 = (int)((int64_t)height * sy / num_v);
      r.w = (int)((int64_t)width * (sx + 1) / num_h) - r.x0;
      r.h = (int)((int64_t)height * (sy + 1) / num_v) - r.y0;
      e->rects.push_back(r);
    }
  e->slices.assign(e->rects.size(), SliceState());
  return e;
}

void m2de_ffv1_encoder_free(void *enc) { delete static_cast<Encoder *>(enc); }

int64_t m2de_ffv1_encoder_extradata(void *enc, uint8_t *out, int64_t capacity) {
  Encoder &e = *static_cast<Encoder *>(enc);
  if (out && capacity >= (int64_t)e.extradata.size())
    std::memcpy(out, e.extradata.data(), e.extradata.size());
  return (int64_t)e.extradata.size();
}

// Encodes n frames (n x height x width uint16, C order), the slices on up
// to `threads` threads. Returns the batch's total bytes; sizes[i] and
// keys[i] describe frame i. m2de_ffv1_encoder_fetch copies the bytes out.
int64_t m2de_ffv1_encode(void *enc, const uint16_t *frames, int n, int threads, int64_t *sizes,
                         uint8_t *keys) {
  Encoder &e = *static_cast<Encoder *>(enc);
  const size_t ns = e.rects.size();
  const int64_t frame_px = (int64_t)e.width * e.height;
  std::vector<std::vector<uint8_t>> parts((size_t)n * ns);
  std::vector<uint8_t> key(n);
  for (int f = 0; f < n; f++) key[f] = (e.frame_number + f) % e.gop == 0;
  const int nthreads = std::max(1, std::min<int>(threads, (int)ns));
  run_threads(nthreads, [&](int t) {
    Rows rows;
    for (size_t s = t; s < ns; s += nthreads)
      for (int f = 0; f < n; f++)
        encode_slice(e, frames + f * frame_px, (int)s, key[f], e.slices[s], rows,
                     parts[(size_t)f * ns + s]);
  });
  e.frame_number += n;
  int64_t total = 0;
  for (int f = 0; f < n; f++) {
    int64_t size = 0;
    for (size_t s = 0; s < ns; s++) size += (int64_t)parts[(size_t)f * ns + s].size();
    sizes[f] = size;
    keys[f] = key[f];
    total += size;
  }
  e.packets.resize((size_t)total);
  uint8_t *p = e.packets.data();
  for (auto &part : parts) {
    std::memcpy(p, part.data(), part.size());
    p += part.size();
  }
  return total;
}

void m2de_ffv1_encoder_fetch(void *enc, uint8_t *out) {
  Encoder &e = *static_cast<Encoder *>(enc);
  std::memcpy(out, e.packets.data(), e.packets.size());
}

}  // extern "C"
