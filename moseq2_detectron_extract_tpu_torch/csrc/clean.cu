// Fused frame clean for Hopper, sm_90a: 3x3 median, then 3 erosions and 3
// dilations with the 9x9 elliptical structuring element, uint8 in and out.
//
// Replaces the Pallas TPU kernel
//   moseq2_detectron_extract_tpu/ops/pallas_clean.py:_clean_kernel
// (launched by _fused_clean_impl, entry fused_clean_frames), which cleans every
// selected detection window (proc/features.py:clean_frames).
//
// Function, as the TPU kernel computes it. The frame is embedded in zeros (a
// zero halo, not cv2's border rules); the median and the six min/max passes
// run over the embedded image, values outside the frame included, and only
// the frame is written back. On frames whose border is zero this equals
// clean_frames(frames, iters_tail=3) with cv2 border semantics.
//   erode:   min over the 57 taps of cv2.getStructuringElement(
//            MORPH_ELLIPSE, (9, 9)); its rows dy = -4..4 span dx in
//            [-w, w] with w = 0, 3, 3, 4, 4, 4, 3, 3, 0
//   dilate:  max over the same taps (the ellipse is symmetric)
// Order statistics are exact in any integer type, so the 16-bit lanes below
// give the TPU kernel's int32 results bit for bit.
//
// What bounds it on an H100. It reads and writes each pixel once (2 bytes)
// and needs 90 two-input min/max per pixel in its minimal form (median 18,
// each of the six erosions and dilations 12; chip_smoke.py counts it and
// tests/test_torch_clean.py runs that form). The card's widest min/max is
// VIMNMX3.U16x2: two 16-bit lanes, three inputs, so 4 two-input min/max per
// instruction, at 64 instructions per SM per clock: 4 * 64 * 132 SMs *
// 1.98 GHz = 66.9e12 per second. The operations bound it, not the bytes.
//
// What the first design lost. It ran one thread per pixel and byte: a
// 9-round transposition-network median (144 min/max against 18), all 57
// taps of each erosion as separate shared-memory byte loads (56 min/max
// against 12), an integer division and modulo per pixel, and 32-row tiles
// whose 25-px halo made the seven passes compute 2.06x the tile.
//
// Packed arithmetic. cuobjdump -sass of this library's build for sm_90a
// (CUDA 12.9) shows __vimin3_u16x2 / __vimax3_u16x2 as one VIMNMX3.U16x2,
// __vminu2 as one VIMNMX.U16x2, and __vminu4 / __vmaxu4 (4 x u8) as six
// instructions (LOP3, SHF, IADD, PRMT): bytes are emulated, 16-bit lanes are
// not. So a 32-bit word holds the same pixel of two frames, frame 2p in the
// low lane and 2p + 1 in the high lane, and every operation below cleans
// two frames at once. Neighbouring pixels are neighbouring words, so a
// stencil shift costs no byte permute, only an address.
//
// Design. One block per (pair of frames, tile). The block stages its tile
// with a 25-row and 32-column zero halo (the stack's reach, 1 + 4*3 + 4*3,
// the columns rounded up to 16-byte loads) into shared memory as packed
// words, then runs the seven passes between two buffers, each computing only
// the margin the later passes still need (24, 20, ..., 4, 0: the TPU
// kernel's shrinking margins). The last pass writes the tile to device
// memory. 512 threads; a thread takes 4 neighbouring words (one 16-byte
// shared load per row and group) and walks down 8 rows:
//   median   per row, sort each column's vertical triple once (min3, max3,
//            and the sum less both for the middle) for the 6 columns its 4
//            outputs touch; then med3(max3 of the lows, med3 of the mids,
//            min3 of the highs) per output; med3 is the sum less min3 and
//            max3 (lanes hold 0..255, so 32-bit sums never carry across).
//   erode    per row, the row extrema of widths 7 and 9 (h7, h9; width 1 is
//   dilate   the word itself) with 4 three-input ops per word; the ellipse's
//            9 rows then combine from registers with 4 more: 8 VIMNMX3 per
//            word and pass, 4 instructions per pixel, where the minimal
//            form's 12 two-input min/max would take 6 VIMNMX.U16x2.
// A thread's walk reads 8 rows more than the 8 it writes (2 for the median),
// which doubles the row-extrema work; with 16 rows a thread the kernel needs
// more registers and runs slower on the card. That and the halo are the
// recomputation. ops/clean_kernel.py:tile_plan chooses the
// tile; for the main path's (64, 160, 160) it takes 80 x 80 tiles, 128
// blocks for 132 SMs, whose passes compute 1.73x the tile's words
// (the sum over the seven margins m of (80 + 2m)^2, over 7 * 80^2), against
// 2.06x before, and 1.33x for a whole frame per block, which would leave
// half the SMs idle (64 blocks) and need 2 x 210 x 224 x 4 B of shared
// memory for two frames, over the 227 KB limit.
// Staging reads 16 bytes of each frame per load where the frame's width is
// a multiple of 16, and single bytes elsewhere; the last pass stores 4
// bytes of each frame per word group where the width is a multiple of 4.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 25;       // 1 (median) + 3 * 4 (erode) + 3 * 4 (dilate)
constexpr int kPadCols = 32;    // staged columns left (and right) of the tile
constexpr int kThreads = 512;
constexpr int kSeg = 8;         // output rows per thread item
constexpr int kGroup = 4;       // words per thread item: one 16-byte access

struct MinOp {
  static __device__ __forceinline__ uint32_t op3(uint32_t a, uint32_t b, uint32_t c) {
    return __vimin3_u16x2(a, b, c);
  }
};

struct MaxOp {
  static __device__ __forceinline__ uint32_t op3(uint32_t a, uint32_t b, uint32_t c) {
    return __vimax3_u16x2(a, b, c);
  }
};

// Lane-wise median of three: the sum less the minimum and the maximum.
__device__ __forceinline__ uint32_t med3(uint32_t a, uint32_t b, uint32_t c) {
  return a + b + c - __vimin3_u16x2(a, b, c) - __vimax3_u16x2(a, b, c);
}

struct Tile {
  const uint8_t* in0;   // frame 2p
  const uint8_t* in1;   // frame 2p + 1, or null past the last frame
  uint8_t* out0;
  uint8_t* out1;
  int H, W;
  int r0, c0;           // the tile's first frame row and column
  int th, tw;           // the tile's rows and columns (ragged at the edge)
  int rows, pitch;      // staged rows, words per staged row
};

// The items of a pass at margin m: groups of 4 words across the region,
// segments of kSeg rows down it.
struct Region {
  int c_lo, groups, r_lo, nrows, segs;
  __device__ Region(const Tile& t, int m)
      : c_lo(kPadCols - m),
        groups((t.tw + 2 * m + kGroup - 1) / kGroup),
        r_lo(kHalo - m),
        nrows(t.th + 2 * m),
        segs((t.th + 2 * m + kSeg - 1) / kSeg) {}
};

// Byte j of each frame's 4 pixels into the two 16-bit lanes of one word.
__device__ __forceinline__ uint32_t pack_pixel(uint32_t f0, uint32_t f1, int j) {
  return __byte_perm(f0, f1, static_cast<uint32_t>(j | ((4 + j) << 8))) & 0x00ff00ffu;
}

// Stage the pair's tile and its zero halo: rows x pitch packed words, in
// chunks of 16 pixels.
__device__ void stage(const Tile& t, uint32_t* dst, bool vec_in) {
  const int chunks = t.pitch / 16;
  for (int item = threadIdx.x; item < t.rows * chunks; item += blockDim.x) {
    const int ly = item / chunks;
    const int k = item - ly * chunks;
    const int gy = t.r0 - kHalo + ly;
    const int gx = t.c0 - kPadCols + 16 * k;
    uint4* d = reinterpret_cast<uint4*>(dst + ly * t.pitch + 16 * k);
    const bool row_in = gy >= 0 && gy < t.H;
    if (row_in && vec_in && gx >= 0 && gx + 16 <= t.W) {
      const size_t off = static_cast<size_t>(gy) * t.W + gx;
      const uint4 f0 = *reinterpret_cast<const uint4*>(t.in0 + off);
      const uint4 f1 = t.in1 ? *reinterpret_cast<const uint4*>(t.in1 + off)
                             : make_uint4(0, 0, 0, 0);
      const uint32_t a[4] = {f0.x, f0.y, f0.z, f0.w};
      const uint32_t b[4] = {f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        d[v] = make_uint4(pack_pixel(a[v], b[v], 0), pack_pixel(a[v], b[v], 1),
                          pack_pixel(a[v], b[v], 2), pack_pixel(a[v], b[v], 3));
      }
    } else {
      uint32_t w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int x = gx + j;
        uint32_t v = 0;
        if (row_in && x >= 0 && x < t.W) {
          const size_t off = static_cast<size_t>(gy) * t.W + x;
          v = t.in0[off] | (t.in1 ? static_cast<uint32_t>(t.in1[off]) << 16 : 0u);
        }
        w[j] = v;
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) d[v] = make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
    }
  }
  __syncthreads();
}

// Store 4 packed words of local row ly, local column lx (the last pass).
__device__ __forceinline__ void store_global(const Tile& t, int ly, int lx, const uint32_t r[4]) {
  const int y = ly - kHalo;
  const int x = lx - kPadCols;   // a multiple of 4
  if (y < 0 || y >= t.th || x >= t.tw) return;
  const size_t off = static_cast<size_t>(t.r0 + y) * t.W + t.c0 + x;
  if ((t.W & 3) == 0 && x + 4 <= t.tw) {
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x6240);   // f0 p0, f0 p1, f1 p0, f1 p1
    const uint32_t lo23 = __byte_perm(r[2], r[3], 0x6240);
    *reinterpret_cast<uint32_t*>(t.out0 + off) = __byte_perm(lo01, lo23, 0x5410);
    if (t.out1) *reinterpret_cast<uint32_t*>(t.out1 + off) = __byte_perm(lo01, lo23, 0x7632);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (x + q < t.tw) {
        t.out0[off + q] = static_cast<uint8_t>(r[q]);
        if (t.out1) t.out1[off + q] = static_cast<uint8_t>(r[q] >> 16);
      }
    }
  }
}

// 3x3 median of the region at margin m, src -> dst (both shared).
__device__ void median_pass(const Tile& t, const uint32_t* src, uint32_t* dst, int m) {
  const Region g(t, m);
  for (int item = threadIdx.x; item < g.groups * g.segs; item += blockDim.x) {
    const int seg = item / g.groups;
    const int lx = g.c_lo + (item - seg * g.groups) * kGroup;
    const int y0 = g.r_lo + seg * kSeg;
    const int n_out = min(kSeg, g.r_lo + g.nrows - y0);
    uint32_t v[kSeg + 2][6];     // words lx - 1 .. lx + 4 of rows y0 - 1 ..
#pragma unroll
    for (int i = 0; i < kSeg + 2; ++i) {
      const int y = min(y0 - 1 + i, t.rows - 1);
      const uint32_t* row = src + y * t.pitch + lx;
      const uint4 mid = *reinterpret_cast<const uint4*>(row);
      v[i][0] = row[-1];
      v[i][1] = mid.x;
      v[i][2] = mid.y;
      v[i][3] = mid.z;
      v[i][4] = mid.w;
      v[i][5] = row[4];
      if (i >= 2 && i - 2 < n_out) {
        uint32_t lo[6], md[6], hi[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const uint32_t a = v[i - 2][k], b = v[i - 1][k], c = v[i][k];
          lo[k] = __vimin3_u16x2(a, b, c);
          hi[k] = __vimax3_u16x2(a, b, c);
          md[k] = a + b + c - lo[k] - hi[k];
        }
        uint32_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          r[q] = med3(__vimax3_u16x2(lo[q], lo[q + 1], lo[q + 2]),
                      med3(md[q], md[q + 1], md[q + 2]),
                      __vimin3_u16x2(hi[q], hi[q + 1], hi[q + 2]));
        }
        *reinterpret_cast<uint4*>(dst + (y0 + i - 2) * t.pitch + lx) =
            make_uint4(r[0], r[1], r[2], r[3]);
      }
    }
  }
  __syncthreads();
}

// Erosion (MinOp) or dilation (MaxOp) with the 9x9 ellipse of the region at
// margin m, src (shared) -> dst (shared), or -> the frames (kLast).
template <class Op, bool kLast>
__device__ void morph_pass(const Tile& t, const uint32_t* src, uint32_t* dst, int m) {
  const Region g(t, m);
  for (int item = threadIdx.x; item < g.groups * g.segs; item += blockDim.x) {
    const int seg = item / g.groups;
    const int lx = g.c_lo + (item - seg * g.groups) * kGroup;
    const int y0 = g.r_lo + seg * kSeg;
    const int n_out = min(kSeg, g.r_lo + g.nrows - y0);
    // row extrema of widths 1, 7 and 9 of input rows y0 - 4 .. y0 + kSeg + 3
    uint32_t h1[kSeg + 8][kGroup], h7[kSeg + 8][kGroup], h9[kSeg + 8][kGroup];
#pragma unroll
    for (int i = 0; i < kSeg + 8; ++i) {
      const int y = min(y0 - 4 + i, t.rows - 1);
      const uint4* row = reinterpret_cast<const uint4*>(src + y * t.pitch + lx - 4);
      const uint4 a = row[0], b = row[1], c = row[2];
      const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        h1[i][q] = w[q + 4];
        h7[i][q] = Op::op3(Op::op3(w[q + 1], w[q + 2], w[q + 3]), w[q + 4],
                           Op::op3(w[q + 5], w[q + 6], w[q + 7]));
        h9[i][q] = Op::op3(h7[i][q], w[q], w[q + 8]);
      }
      if (i >= 8 && i - 8 < n_out) {
        // output row y0 + i - 8, centred on input i - 4: the ellipse's rows
        // are h1, h7, h7, h9, h9, h9, h7, h7, h1
        uint32_t r[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          r[q] = Op::op3(Op::op3(h1[i - 8][q], h1[i][q], h7[i - 7][q]),
                         Op::op3(h7[i - 6][q], h7[i - 2][q], h7[i - 1][q]),
                         Op::op3(h9[i - 5][q], h9[i - 4][q], h9[i - 3][q]));
        }
        if (kLast) {
          store_global(t, y0 + i - 8, lx, r);
        } else {
          *reinterpret_cast<uint4*>(dst + (y0 + i - 8) * t.pitch + lx) =
              make_uint4(r[0], r[1], r[2], r[3]);
        }
      }
    }
  }
  if (!kLast) __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
clean_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int N, int H,
             int W, int tile_h, int tile_w, int tiles_y, int tiles_x, bool vec_in) {
  extern __shared__ uint4 smem[];
  int blk = blockIdx.x;
  const int tx = blk % tiles_x;
  blk /= tiles_x;
  const int ty = blk % tiles_y;
  const int n0 = 2 * (blk / tiles_y);
  const size_t frame = static_cast<size_t>(H) * W;

  Tile t;
  t.in0 = in + n0 * frame;
  t.out0 = out + n0 * frame;
  t.in1 = n0 + 1 < N ? t.in0 + frame : nullptr;
  t.out1 = n0 + 1 < N ? t.out0 + frame : nullptr;
  t.H = H;
  t.W = W;
  t.r0 = ty * tile_h;
  t.c0 = tx * tile_w;
  t.th = min(tile_h, H - t.r0);
  t.tw = min(tile_w, W - t.c0);
  t.rows = t.th + 2 * kHalo;
  t.pitch = tile_w + 2 * kPadCols;
  uint32_t* a = reinterpret_cast<uint32_t*>(smem);
  uint32_t* b = a + (tile_h + 2 * kHalo) * t.pitch;

  stage(t, a, vec_in);
  median_pass(t, a, b, 24);
  morph_pass<MinOp, false>(t, b, a, 20);
  morph_pass<MinOp, false>(t, a, b, 16);
  morph_pass<MinOp, false>(t, b, a, 12);
  morph_pass<MaxOp, false>(t, a, b, 8);
  morph_pass<MaxOp, false>(t, b, a, 4);
  morph_pass<MaxOp, true>(t, a, nullptr, 0);
}

}  // namespace

extern "C" int m2de_clean_smem_bytes(int tile_h, int tile_w) {
  return 2 * (tile_h + 2 * kHalo) * (tile_w + 2 * kPadCols) * 4;
}

extern "C" int m2de_clean_u8(const void* in, void* out, int N, int H, int W,
                             int tile_h, int tile_w, void* stream) {
  if (N < 0 || H < 0 || W < 0 || tile_h < 1 || tile_w < 16 || tile_w % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0 || H == 0 || W == 0) return 0;
  const int smem = m2de_clean_smem_bytes(tile_h, tile_w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        clean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const long long blocks = static_cast<long long>((N + 1) / 2) * tiles_y * tiles_x;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = (W % 16) == 0 && (reinterpret_cast<uintptr_t>(in) % 16) == 0;
  clean_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), N, H, W, tile_h,
      tile_w, tiles_y, tiles_x, vec_in);
  return static_cast<int>(cudaGetLastError());
}
