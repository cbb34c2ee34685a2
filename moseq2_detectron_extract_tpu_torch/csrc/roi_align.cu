// Fused multilevel ROIAlignV2 (aligned, sampling ratio 2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   moseq2_detectron_extract_tpu/ops/pallas_roi_align.py:_kernel
// (launched by _pallas_impl, entry pallas_separable_roi_align), which pools every
// ROI of the box, mask and keypoint heads (models/rcnn.py:_pool). It computes
// the same function, not the TPU's blocking: the TPU kernel writes the
// bilinear taps as two small matmuls (Wy @ F_stack, then a contraction with
// Wx over W) because its matrix unit is idle otherwise. Here each output is a
// direct bilinear gather.
//
// Function. Each ROI (x1, y1, x2, y2) takes the FPN level
//   clamp(floor(4 + log2(sqrt(area) / 224 + 1e-8)), min_level, max_level),
// is sampled at 2*out x 2*out half-pixel points in that level's units,
//   c = (lo + (hi - lo) * (i + 0.5) / (2*out)) / 2^level - 0.5,
// clamped into [0, size - 1] (clamped, not zeroed), interpolated
// bilinearly, and each 2x2 group of samples is averaged into one output.
//
// Layout. The four levels P2..P5 are read through four pointers, each NHWC
// (B, H_l, W_l, C) bf16 and contiguous; boxes (B, K, 4) f32; the output is
// (B, K, out, out, C) bf16. Taps are read as bf16 pairs and converted to
// fp32; all sums are fp32; the result is rounded to bf16 once.
//
// What bounds it on an H100. The work is a gather: at most 16 taps per
// output element (4 samples x 4 bilinear taps, weights per ROI and shared by
// the channels), so 16 fp32 multiply-adds (32 operations) per element against
// 2 bytes written per element and the taps read.
// At the main-path shapes (C = 256, out = 7 with K = 16, out = 14 and 7 with
// K = 1, batch 16) the bytes (taps touched + output, over 3.35 TB/s) bound it,
// not the operations (over the 67 TFLOP/s fp32 rate).
//
// Design. One block per (ROI, output row): the block computes the ROI's
// level and its sample coordinates itself, once, into shared memory; its
// threads then run over (output column, channel pair), so neighbouring
// threads read neighbouring channels of one NHWC tap row: a warp reads
// 128 contiguous bytes per tap. Splitting a ROI over its output rows gives
// B*K*out blocks, enough to spread the K = 1 stages over the card's 132 SMs.
// Coordinates use round-to-nearest intrinsics (no fused multiply-add) so they
// are bit-identical to the plain PyTorch version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOut = 32;     // output_size limit: 2*out samples per axis
constexpr int kThreads = 256;   // >= 2 + 2*kMaxOut coordinate threads

struct Pyramid {
  const __nv_bfloat162* level[4];
  int height[4];
  int width[4];
};

// One sample coordinate along an axis, as ops/roi_align.py computes it.
__device__ __forceinline__ void sample_coord(float lo, float hi, int i, int s,
                                             float stride, int size, int* c0,
                                             int* c1, float* frac) {
  const float f = __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                            static_cast<float>(s));
  const float img = __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), f));
  float c = __fsub_rn(__fdiv_rn(img, stride), 0.5f);
  c = fminf(fmaxf(c, 0.0f), static_cast<float>(size - 1));
  const float fl = floorf(c);
  *frac = __fsub_rn(c, fl);
  *c0 = static_cast<int>(fl);
  *c1 = min(*c0 + 1, size - 1);
}

__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Pyramid pyr, int n_levels, int min_level,
                 const float* __restrict__ boxes,
                 __nv_bfloat162* __restrict__ out, int K, int C2, int out_size) {
  const int roi = blockIdx.x;   // b * K + k
  const int oy = blockIdx.y;    // output row
  const int b = roi / K;
  const int s = 2 * out_size;

  __shared__ int s_y0[2], s_y1[2];
  __shared__ float s_fy[2];
  __shared__ int s_x0[2 * kMaxOut], s_x1[2 * kMaxOut];
  __shared__ float s_fx[2 * kMaxOut];

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
  const int li = level - min_level;
  const float stride = static_cast<float>(1 << level);
  const int H = pyr.height[li];
  const int W = pyr.width[li];

  const int t = threadIdx.x;
  if (t < 2) {
    sample_coord(by1, by2, 2 * oy + t, s, stride, H, &s_y0[t], &s_y1[t], &s_fy[t]);
  } else if (t - 2 < s) {
    const int i = t - 2;
    sample_coord(bx1, bx2, i, s, stride, W, &s_x0[i], &s_x1[i], &s_fx[i]);
  }
  __syncthreads();

  const __nv_bfloat162* feat = pyr.level[li] + static_cast<size_t>(b) * H * W * C2;
  __nv_bfloat162* dst = out + (static_cast<size_t>(roi) * out_size + oy) * out_size * C2;
  const int work = out_size * C2;
  for (int idx = t; idx < work; idx += blockDim.x) {
    const int ox = idx / C2;
    const int c = idx - ox * C2;
    float ax = 0.0f, ay = 0.0f;
#pragma unroll
    for (int sy = 0; sy < 2; ++sy) {
      const float fy = s_fy[sy];
      const __nv_bfloat162* r0 = feat + static_cast<size_t>(s_y0[sy]) * W * C2 + c;
      const __nv_bfloat162* r1 = feat + static_cast<size_t>(s_y1[sy]) * W * C2 + c;
#pragma unroll
      for (int sx = 0; sx < 2; ++sx) {
        const int i = 2 * ox + sx;
        const float fx = s_fx[i];
        const int x0 = s_x0[i] * C2;
        const int x1 = s_x1[i] * C2;
        const float2 v00 = __bfloat1622float2(r0[x0]);
        const float2 v01 = __bfloat1622float2(r0[x1]);
        const float2 v10 = __bfloat1622float2(r1[x0]);
        const float2 v11 = __bfloat1622float2(r1[x1]);
        ax += (v00.x * (1.0f - fx) + v01.x * fx) * (1.0f - fy) +
              (v10.x * (1.0f - fx) + v11.x * fx) * fy;
        ay += (v00.y * (1.0f - fx) + v01.y * fx) * (1.0f - fy) +
              (v10.y * (1.0f - fx) + v11.y * fx) * fy;
      }
    }
    dst[ox * C2 + c] = __floats2bfloat162_rn(ax * 0.25f, ay * 0.25f);
  }
}

}  // namespace

extern "C" int m2de_roi_align_bf16(const void* p2, const void* p3, const void* p4,
                                   const void* p5, int h2, int h3, int h4, int h5,
                                   int w2, int w3, int w4, int w5, int n_levels,
                                   int min_level, const void* boxes, void* out,
                                   int B, int K, int C, int out_size, void* stream) {
  if (n_levels < 1 || n_levels > 4 || out_size < 1 || out_size > kMaxOut ||
      C < 2 || (C & 1) || B < 0 || K < 0 || min_level < 0 ||
      min_level + n_levels > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || K == 0) return 0;
  Pyramid pyr;
  const void* ptrs[4] = {p2, p3, p4, p5};
  const int hs[4] = {h2, h3, h4, h5};
  const int ws[4] = {w2, w3, w4, w5};
  for (int i = 0; i < 4; ++i) {
    pyr.level[i] = static_cast<const __nv_bfloat162*>(ptrs[i]);
    pyr.height[i] = hs[i];
    pyr.width[i] = ws[i];
  }
  const dim3 grid(static_cast<unsigned>(B * K), static_cast<unsigned>(out_size));
  roi_align_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pyr, n_levels, min_level, static_cast<const float*>(boxes),
      static_cast<__nv_bfloat162*>(out), K, C / 2, out_size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* m2de_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
