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
//   median:  9-input odd-even transposition network, 9 rounds (exact sort)
//   erode:   min over the 57 taps of cv2.getStructuringElement(
//            MORPH_ELLIPSE, (9, 9)); its rows dy = -4..4 span dx in
//            [-w, w] with w = 0, 3, 3, 4, 4, 4, 3, 3, 0
//   dilate:  max over the reflected taps (the ellipse is symmetric)
// Order statistics are exact in any integer type, so uint8 storage between
// passes gives the TPU kernel's int32 results bit for bit.
//
// What bounds it on an H100. It reads and writes each pixel once (2 bytes).
// A minimal form of the function needs 90 min/max operations per pixel:
//   median  18: sort each vertical triple (6), then
//               med3(max of the 3 lows, med3 of the 3 mids, min of the 3 highs)
//               over the neighbouring columns (2 + 4 + 2 + 4);
//   each of the six erosions and dilations 12: row minima of widths 7 and 9
//               by doubling (5), then the 9 rows of the ellipse, sharing the
//               pairs of equal rows (7).
// At 67e12 min/max per second (the fp32 rate outside the tensor cores; a
// scalar int32 min/max issues at 64 per SM per clock, a quarter of that) the
// operations bound it, not the bytes: 90 ops against 2 bytes per pixel.
// This kernel does far more than that: its median is a 9-round
// transposition network (72 compare-exchanges) and each pass takes all 57
// taps from shared memory, one byte load each.
//
// Design. One block per (frame, tile of rows). The block stages its tile
// plus a 25-pixel zero halo (1 + 4*3 + 4*3, the reach of the whole stack)
// into shared memory once, then runs the seven passes between two shared
// buffers, each pass computing only the margin the later passes still need
// (25 -> 24 -> 20 -> 16 -> 12 -> 8 -> 4 -> 0, as pallas_clean.py:89-106
// shrinks its margins); the last pass writes the tile to device memory.
// Device memory is touched once per pixel in and once out; every stencil tap
// is a shared-memory read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 25;       // 1 (median) + 3 * 4 (erode) + 3 * 4 (dilate)
constexpr int kThreads = 256;

// Half width of row dy of cv2's 9x9 MORPH_ELLIPSE (57 taps).
__device__ __forceinline__ int ellipse_half_width(int dy) {
  return (dy == -4 || dy == 4) ? 0 : ((dy >= -1 && dy <= 1) ? 4 : 3);
}

__device__ __forceinline__ void sort2(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

__device__ __forceinline__ uint8_t median9(const uint8_t* p, int pitch) {
  int v[9];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) v[(dy + 1) * 3 + dx + 1] = p[dy * pitch + dx];
  }
#pragma unroll
  for (int round = 0; round < 9; ++round) {
#pragma unroll
    for (int i = 0; i < 8; i += 2) sort2(v[i], v[i + 1]);
#pragma unroll
    for (int i = 1; i < 8; i += 2) sort2(v[i], v[i + 1]);
  }
  return static_cast<uint8_t>(v[4]);
}

__device__ __forceinline__ uint8_t erode9(const uint8_t* p, int pitch) {
  int acc = 255;
#pragma unroll
  for (int dy = -4; dy <= 4; ++dy) {
    const int hw = ellipse_half_width(dy);
#pragma unroll
    for (int dx = -4; dx <= 4; ++dx) {
      if (dx >= -hw && dx <= hw) acc = min(acc, static_cast<int>(p[dy * pitch + dx]));
    }
  }
  return static_cast<uint8_t>(acc);
}

__device__ __forceinline__ uint8_t dilate9(const uint8_t* p, int pitch) {
  int acc = 0;
#pragma unroll
  for (int dy = -4; dy <= 4; ++dy) {
    const int hw = ellipse_half_width(dy);
#pragma unroll
    for (int dx = -4; dx <= 4; ++dx) {
      if (dx >= -hw && dx <= hw) acc = max(acc, static_cast<int>(p[-dy * pitch - dx]));
    }
  }
  return static_cast<uint8_t>(acc);
}

enum Op { kMedian, kErode, kDilate };

template <Op op>
__device__ __forceinline__ uint8_t apply(const uint8_t* p, int pitch) {
  if (op == kMedian) return median9(p, pitch);
  if (op == kErode) return erode9(p, pitch);
  return dilate9(p, pitch);
}

// One pass over the region at margin m_out around the tile (local coords:
// the tile's first pixel sits at (kHalo, kHalo)).
template <Op op>
__device__ void pass(const uint8_t* src, uint8_t* dst, int pitch, int th, int W,
                     int m_out) {
  const int origin = kHalo - m_out;   // first local row and column
  const int rh = th + 2 * m_out;
  const int rw = W + 2 * m_out;
  for (int i = threadIdx.x; i < rh * rw; i += blockDim.x) {
    const int ly = origin + i / rw;
    const int lx = origin + i % rw;
    dst[ly * pitch + lx] = apply<op>(src + ly * pitch + lx, pitch);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
clean_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int H,
             int W, int tile_h, int tiles) {
  extern __shared__ uint8_t smem[];
  const int n = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - n * tiles) * tile_h;
  const int th = min(tile_h, H - r0);
  const int pitch = W + 2 * kHalo;
  uint8_t* a = smem;
  uint8_t* b = smem + (tile_h + 2 * kHalo) * pitch;

  // stage the tile and its zero halo
  const uint8_t* frame = in + static_cast<size_t>(n) * H * W;
  const int rows = th + 2 * kHalo;
  for (int i = threadIdx.x; i < rows * pitch; i += blockDim.x) {
    const int ly = i / pitch;
    const int lx = i - ly * pitch;
    const int gy = r0 - kHalo + ly;
    const int gx = lx - kHalo;
    a[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? frame[gy * W + gx] : 0;
  }
  __syncthreads();

  pass<kMedian>(a, b, pitch, th, W, 24);
  pass<kErode>(b, a, pitch, th, W, 20);
  pass<kErode>(a, b, pitch, th, W, 16);
  pass<kErode>(b, a, pitch, th, W, 12);
  pass<kDilate>(a, b, pitch, th, W, 8);
  pass<kDilate>(b, a, pitch, th, W, 4);

  // last dilation straight to device memory
  uint8_t* dst = out + static_cast<size_t>(n) * H * W + static_cast<size_t>(r0) * W;
  for (int i = threadIdx.x; i < th * W; i += blockDim.x) {
    const int y = i / W;
    const int x = i - y * W;
    dst[y * W + x] = dilate9(a + (kHalo + y) * pitch + kHalo + x, pitch);
  }
}

}  // namespace

extern "C" int m2de_clean_smem_bytes(int W, int tile_h) {
  return 2 * (tile_h + 2 * kHalo) * (W + 2 * kHalo);
}

extern "C" int m2de_clean_u8(const void* in, void* out, int N, int H, int W,
                             int tile_h, void* stream) {
  if (N < 0 || H < 0 || W < 0 || tile_h < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0 || H == 0 || W == 0) return 0;
  const int smem = m2de_clean_smem_bytes(W, tile_h);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        clean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (H + tile_h - 1) / tile_h;
  clean_kernel<<<static_cast<unsigned>(N * tiles), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H, W, tile_h,
      tiles);
  return static_cast<int>(cudaGetLastError());
}
