// Fused multilevel ROIAlignV2 (aligned, sampling ratio 2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   moseq2_detectron_extract_tpu/ops/pallas_roi_align.py:_kernel
// (launched by _pallas_impl, entry pallas_separable_roi_align), which pools every
// ROI of the box, mask and keypoint heads (models/rcnn.py:_pool). It computes
// the same function, not the TPU's blocking: the TPU kernel writes the
// bilinear taps as two small matmuls (Wy @ F_stack, then a contraction with
// Wx over W) because its matrix unit is idle otherwise.
//
// Function. Each ROI (x1, y1, x2, y2) takes the FPN level
//   clamp(floor(4 + log2(sqrt(area) / 224 + 1e-8)), min_level, max_level),
// is sampled at 2*out x 2*out half-pixel points in that level's units,
//   c = (lo + (hi - lo) * (i + 0.5) / (2*out)) / 2^level - 0.5,
// clamped into [0, size - 1] (clamped, not zeroed), interpolated
// bilinearly, and each 2x2 group of samples is averaged into one output.
//
// Layout. Four levels P2..P5, each an NHWC (B, H_l, W_l, C) bf16 view with
// its own batch, row and column strides and channel stride 1 (a
// channels_last NCHW tensor permuted to NHWC is such a view); boxes
// (B, K, 4) f32; the output (B, K, out, out, C) bf16. Sums are f32; the
// result is rounded to bf16 once.
//
// What bounds it on an H100. The function moves bytes: 16 multiply-adds
// (32 operations) per output element against 2 bytes written per element
// and the taps read. Its M is out = 7 or 14 rows, far below the 64 rows of
// a wgmma tile: a tensor-core form would pad M 5-9x, round the
// interpolation weights to bf16 and still build them per ROI
// (benchmarks/roi_stage2_exp.py fought this M = 7 problem on the TPU's
// matrix unit). So the design aims at bytes, instructions and occupancy.
//
// What the first design lost. One block per (ROI, output row) gathered all
// 16 taps of every output element with 4-byte bf16x2 loads: 16 * 16 * 49 *
// 16 * 512 B = 103 MB of L1/L2 traffic in the box stage (B 16, K 16, out 7,
// C 256) for about 17 MB of distinct taps, each tap read about 6 times; the
// K = 1 stages ran 112-224 blocks close to the cost of a launch.
//
// What a shared-memory design lost. Staging each ROI's footprint for a
// 64-channel slice into shared memory (cp.async), then interpolating along
// y into shared memory and along x into registers, read each tap once, but
// its four barrier-separated phases and its index arithmetic per staged
// tap made it slower than the first design in the box stage (PERF.md,
// PR 5).
//
// Design. A warp owns one output row oy of one ROI (or a segment of that
// row's columns), and its 32 lanes own 8 consecutive channels each (V = 8,
// one 16-byte load per tap: a warp reads a tap's 256 channels as 512
// contiguous bytes), or one channel each (V = 1) where the channels or the
// strides do not allow 16-byte loads. The warps are independent: no shared
// memory, no barrier.
// 1. Each lane computes the ROI's level and the row's two y samples
//    (rows y0, y1 and weights of each) itself, and lane j the j-th x sample
//    of the segment; the coordinates are bit-identical to the plain
//    version's (round-to-nearest intrinsics, no fused multiply-add, the
//    plain version's order).
// 2. Walking the x samples in order, the warp computes the y-interpolated
//    column Ty[x] = sum over the 4 (row, weight) pairs of w * f[row][x] (four
//    16-byte loads, f32) for each column a sample touches, keeping the last
//    two columns in registers: samples advance monotonically along x, so each
//    column of the footprint is loaded and interpolated once per row oy.
// 3. Each output is 0.5 * ((1 - fx) Ty[x0] + fx Ty[x1]) summed over its two
//    x samples in f32 registers, rounded to bf16 and stored as 16 bytes per
//    lane.
// Footprints of any size take the same walk: there is no staged capacity.
// The wrapper (ops/roi_align_kernel.py:launch_plan) splits each row into
// segments of columns when the ROIs are few, so the K = 1 stages (16 ROIs a
// batch) still put several warps on every SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOut = 32;     // output_size limit: 2*out <= 64 x samples, 2 per lane
constexpr int kWarps = 4;       // warps per block

struct Level {
  const __nv_bfloat16* base;
  int height, width;
  long long sb, sy, sx;          // strides in elements; the channel stride is 1
};

struct Pyramid {
  Level level[4];
};

// One sample coordinate along an axis, as ops/roi_align.py computes it
// (img / stride there; inv_stride = 1 / stride is a power of two, so the
// product is the same float).
__device__ __forceinline__ void sample_coord(float lo, float hi, int i, int s,
                                             float inv_stride, int size, int* c0,
                                             int* c1, float* frac) {
  const float f = __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                            static_cast<float>(s));
  const float img = __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), f));
  float c = __fsub_rn(__fmul_rn(img, inv_stride), 0.5f);
  c = fminf(fmaxf(c, 0.0f), static_cast<float>(size - 1));
  const float fl = floorf(c);
  *frac = __fsub_rn(c, fl);
  *c0 = static_cast<int>(fl);
  *c1 = min(*c0 + 1, size - 1);
}

// V bf16 channels of one tap: load as f32, store from f32.
template <int V>
struct Chan;

template <>
struct Chan<8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Chan<1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    f[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    *p = __float2bfloat16_rn(f[0]);
  }
};

// grid (B*K ROIs, channel groups of 32*V, ceil(out_size * segs / kWarps));
// the ROI's warp w = (output row w / segs, column segment w % segs).
template <int V>
__global__ void __launch_bounds__(32 * kWarps)
roi_align_kernel(Pyramid pyr, int n_levels, int min_level, const float* __restrict__ boxes,
                 __nv_bfloat16* __restrict__ out, int K, int C, int out_size, int segs) {
  const int roi = blockIdx.x;   // b * K + k
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.z * kWarps + (threadIdx.x >> 5);
  if (warp >= out_size * segs) return;   // the whole warp: no barrier follows
  const int oy = warp / segs;
  const int per_seg = (out_size + segs - 1) / segs;
  const int ox_begin = (warp - oy * segs) * per_seg;
  const int ox_end = min(out_size, ox_begin + per_seg);
  if (ox_begin >= ox_end) return;   // the whole warp: no barrier follows
  const int c = (blockIdx.y * 32 + lane) * V;
  const bool live = c < C;
  const int s = 2 * out_size;

  const float bx1 = boxes[roi * 4 + 0];
  const float by1 = boxes[roi * 4 + 1];
  const float bx2 = boxes[roi * 4 + 2];
  const float by2 = boxes[roi * 4 + 3];

  // FPN level (ops/roi_align.py:assign_fpn_levels)
  const float area = __fmul_rn(fmaxf(__fsub_rn(bx2, bx1), 0.0f),
                               fmaxf(__fsub_rn(by2, by1), 0.0f));
  const float sqrt_area = sqrtf(fmaxf(area, 1e-6f));
  float lvl = floorf(__fadd_rn(
      4.0f, log2f(__fadd_rn(__fdiv_rn(sqrt_area, 224.0f), 1e-8f))));
  lvl = fminf(fmaxf(lvl, static_cast<float>(min_level)),
              static_cast<float>(min_level + n_levels - 1));
  const int level = static_cast<int>(lvl);
  const Level& L = pyr.level[level - min_level];
  const float inv_stride = 1.0f / static_cast<float>(1 << level);

  // this row's two y samples: 4 (row, weight) pairs, the weights halved
  long long row_off[4];
  float wy[4];
#pragma unroll
  for (int sy = 0; sy < 2; ++sy) {
    int y0, y1;
    float fy;
    sample_coord(by1, by2, 2 * oy + sy, s, inv_stride, L.height, &y0, &y1, &fy);
    row_off[2 * sy] = y0 * L.sy;
    row_off[2 * sy + 1] = y1 * L.sy;
    wy[2 * sy] = 0.5f * (1.0f - fy);
    wy[2 * sy + 1] = 0.5f * fy;
  }
  // the segment's x samples, lane j holding samples j and j + 32
  const int j_begin = 2 * ox_begin;
  int xs0[2], xs1[2];
  float xf[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    xs0[h] = xs1[h] = 0;
    xf[h] = 0.0f;
    const int j = j_begin + lane + 32 * h;
    if (j < s) sample_coord(bx1, bx2, j, s, inv_stride, L.width, &xs0[h], &xs1[h], &xf[h]);
  }

  const __nv_bfloat16* feat = L.base + (roi / K) * L.sb + c;
  // Ty of column x: the y interpolation of the row's 4 taps in that column
  auto column = [&](int x, float* t) {
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = 0.0f;
    if (!live) return;
    float f[4][V];
#pragma unroll
    for (int e = 0; e < 4; ++e) Chan<V>::load(feat + row_off[e] + x * L.sx, f[e]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] += wy[e] * f[e][v];
    }
  };
  // the last two columns computed (the walk along x is monotone)
  float t_old[V] = {}, t_new[V] = {};
  int x_old = -1, x_new = -1;
  auto get = [&](int x, float* t) {
    if (x == x_new) {
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = t_new[v];
    } else if (x == x_old) {
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = t_old[v];
    } else {
      column(x, t);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        t_old[v] = t_new[v];
        t_new[v] = t[v];
      }
      x_old = x_new;
      x_new = x;
    }
  };

  __nv_bfloat16* dst = out + (static_cast<size_t>(roi) * out_size + oy) * out_size * C + c;
  for (int ox = ox_begin; ox < ox_end; ++ox) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int sx = 0; sx < 2; ++sx) {
      const int jj = 2 * (ox - ox_begin) + sx;   // the sample's index in the segment
      const int src = jj & 31;
      const bool high = jj >= 32;
      const int x0 = __shfl_sync(0xffffffffu, high ? xs0[1] : xs0[0], src);
      const int x1 = __shfl_sync(0xffffffffu, high ? xs1[1] : xs1[0], src);
      const float fx = __shfl_sync(0xffffffffu, high ? xf[1] : xf[0], src);
      float t0[V], t1[V];
      get(x0, t0);
      get(x1, t1);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += 0.5f * ((1.0f - fx) * t0[v] + fx * t1[v]);
    }
    if (live) Chan<V>::store(dst + static_cast<size_t>(ox) * C, acc);
  }
}

}  // namespace

// levels: n_levels device pointers; meta: per level height, width, and the
// batch, row and column strides in elements. segs: column segments per
// output row (one warp each).
extern "C" int m2de_roi_align_bf16(const void* const* levels, const long long* meta,
                                   int n_levels, int min_level, const void* boxes,
                                   void* out, int B, int K, int C, int out_size, int vec,
                                   int segs, void* stream) {
  if (n_levels < 1 || n_levels > 4 || out_size < 1 || out_size > kMaxOut || C < 1 ||
      B < 0 || K < 0 || min_level < 0 || min_level + n_levels > 30 ||
      (vec != 1 && vec != 8) || C % vec || segs < 1 || segs > out_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || K == 0) return 0;
  Pyramid pyr;
  for (int i = 0; i < 4; ++i) {
    const int l = i < n_levels ? i : 0;
    pyr.level[i].base = static_cast<const __nv_bfloat16*>(levels[l]);
    pyr.level[i].height = static_cast<int>(meta[5 * l + 0]);
    pyr.level[i].width = static_cast<int>(meta[5 * l + 1]);
    pyr.level[i].sb = meta[5 * l + 2];
    pyr.level[i].sy = meta[5 * l + 3];
    pyr.level[i].sx = meta[5 * l + 4];
  }
  const int warps = out_size * segs;
  const dim3 grid(static_cast<unsigned>(B * K), static_cast<unsigned>((C + 32 * vec - 1) / (32 * vec)),
                  static_cast<unsigned>((warps + kWarps - 1) / kWarps));
  const dim3 block(static_cast<unsigned>(32 * min(warps, kWarps)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    roi_align_kernel<8><<<grid, block, 0, st>>>(pyr, n_levels, min_level,
                                                static_cast<const float*>(boxes),
                                                static_cast<__nv_bfloat16*>(out), K, C,
                                                out_size, segs);
  } else {
    roi_align_kernel<1><<<grid, block, 0, st>>>(pyr, n_levels, min_level,
                                                static_cast<const float*>(boxes),
                                                static_cast<__nv_bfloat16*>(out), K, C,
                                                out_size, segs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* m2de_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
