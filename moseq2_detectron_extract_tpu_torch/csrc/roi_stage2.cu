// The four stage-2 layouts of the fused separable ROIAlign, on Hopper's tensor
// cores (sm_90a, mma.sync.m16n8k16 bf16 with f32 accumulators): the streaming
// loop that ported them first. transpose and dotswap launch it; retile and
// noxpose launch roi_stage2_resident.cu's loop, which keeps the image's F
// slice in shared memory (the retile and noxpose paths of the template below
// are no longer instantiated).
//
// Replaces the Pallas TPU kernel bodies of benchmarks/roi_stage2_exp.py,
// launched by its make_variant:
//   m2de_roi_stage2_transpose  <- _kernel_transpose    (l.92)
//   m2de_roi_stage2_dotswap    <- _kernel_dotswap      (l.114)
//
// Function. All four compute the fused separable multilevel ROIAlign
//   T[i, oy, w, c]  = bf16( sum_h Wy[i, oy, h] * F[h, w, c] )        (stage 1)
//   out[i, oy, ox, c] = sum_w Wx[i, ox, w] * T[i, oy, w, c]           (stage 2)
// with F the H-stacked, W-padded pyramid of one image (bf16), Wy and Wx the
// folded interpolation weights rounded to bf16, both stages accumulated in
// f32 and T rounded to bf16 between them, as the TPU's bf16 t_vmem is. The
// output is f32 (and bf16 for noxpose, the experiment's noxpose-bf16);
// noxpose writes (i, oy, c, ox), the others (i, oy, ox, c). Only ROIs i < K
// are written (the wrapper pads the ROIs to a multiple of the block with zero
// weights, as make_variant does).
//
// Layout (ops/roi_stage2_kernel.py builds it): F (B, Hp, Wp, C), Wy (B, Kp, 7,
// Hp), Wx (B, Kp, 7, Wp), bf16, contiguous; Hp and Wp are sum_l H_l and
// max_l W_l padded with zeros to the mma depth of 16, Kp a multiple of the
// block of ROIs (8 or 16). The output size is 7.
//
// What bounds it on an H100. The function itself moves bytes: the taps its
// boxes touch, 32 fp32 operations per output element (PERF.md, row 1). This
// dense form does far more work: stage 1 multiplies every row of the ROI
// block's level bands, B * 7 * Kp * sum H * Wmax * C multiply-adds (2.3e11 at
// the experiment's shape, B 64, K 256, canvas 256, C 256: 0.46 ms at 989
// TFLOP/s), and every block reads its image's F slice again from L2; T never
// reaches device memory. Measured (PERF.md, section 6), the issued mma run at about
// a tenth of the tensor-core peak, and neither half the L2 traffic (BK 16) nor
// half the output bytes (bf16) moves the time: the main loop below is bound
// by latency, one barrier and one cp.async wait behind every 16 mma of a
// warp, with F tiles fetched two steps ahead. That loop is the redesign's
// target (a deeper ring or larger steps, then wgmma and TMA).
//
// Design. One block of 8 warps per (image, block of BK ROIs, slice of 16
// channels). T for a whole ROI block does not fit in shared memory (bk * 7 x
// Wmax * C bf16 is 1.8 MB at BK 8), so the block walks w in tiles of 16:
// 1. Wy and Wx of its ROIs are staged in shared memory once, and the block
//    finds the h and w ranges where any of its weights is nonzero. Tiles
//    outside them are skipped (Wy and Wx are zero there, so the result is the
//    same); inside them stage 1 is dense, including the zero rows of the
//    other levels' bands.
// 2. For each w tile, F tiles of (16 h, 16 w, 16 c) stream through a 3-stage
//    cp.async ring; stage 1 is A = Wy rows (i, oy) from ldmatrix, B = F tile
//    from ldmatrix.trans, each warp owning two w columns (4 n8 tiles) of the
//    tile for all row tiles.
// 3. The stage-1 accumulators are rounded to bf16 into a T tile in shared
//    memory, and stage 2 consumes it at once; its accumulators stay in
//    registers across the w tiles and are stored at the end.
// Shared-memory rows are padded by 16 bytes so ldmatrix reads no bank twice.
//
// The four stage-2 layouts:
// - dotswap, noxpose: A = T with rows (oy, c) and depth w (ldmatrix.trans of
//   the T tile); B = Wx^T with N = ox, 7 padded to mma's n8 by a zero row.
//   One mma per (ROI, oy, 16 channels) and w tile. They differ only in the
//   epilogue's store: (oy, ox, c) against (oy, c, ox).
// - transpose: A = block-diagonal Wx, rows (i, ox) (bk * 7 = 56 or 112),
//   depth (i', w); B = T with depth (i', w) and columns (oy, c), all 7 oy in
//   one pass. The zero blocks are skipped: an m16 row tile multiplies only the
//   k tiles (i', w tile) of the 2-3 ROIs whose rows it holds.
// - retile: the same block-diagonal product, looped over oy outermost with a
//   (bk * 7 x 16 channels) accumulator, as its per-oy product on the TPU:
//   each pass runs stage 1 for the rows (i, oy) of one oy only (M = bk, padded
//   to 16 at BK 8) and streams the F tiles again, 7 passes in all. It trades
//   the transpose form's 7x larger accumulator for 7x the F traffic.
// The retile/transpose split existed on the TPU because of Mosaic's relayout
// limits; on Hopper neither needs a relayout, and the two differ only in the
// loop order above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kOut = 7;                 // output size
constexpr int kOxPad = 8;               // ox padded to mma's n8
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCs = 16;                 // channels per block
constexpr int kWt = 16;                 // w per tile: stage 2's mma depth
constexpr int kHt = 16;                 // h per tile: stage 1's mma depth
constexpr int kStages = 3;              // cp.async ring of F tiles
constexpr int kFRow = kWt * kCs + 8;    // one h row of an F tile, in elements
constexpr int kTRow = kCs + 8;          // one w row of a T tile, in elements
constexpr int kTStride = kWt * kTRow;   // one (i, oy) row of a T tile
constexpr int kMaxSmem = 232448;        // bytes of shared memory a block may use

enum Variant { kRetile = 0, kTranspose = 1, kDotswap = 2, kNoxpose = 3 };

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

int smem_bytes(int variant, int bk, int hp, int wp) {
  const int m_pad = round16(bk * kOut);
  const int t_rows = variant == kRetile ? 16 : m_pad;
  return 16 + 2 * (m_pad * (hp + 8) + bk * kOxPad * (wp + 8) + kStages * kHt * kFRow +
                   t_rows * kTStride);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// d += a * b for one m16n8k16 tile: a holds (row g, k 2t..2t+1), (row g+8, k
// 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..); b (k 2t.., col g), (k 2t+8..,
// col g); d (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1), with g = lane / 4
// and t = lane % 4.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lowest and highest index e (of 8) of a 16-byte chunk whose bf16 is not zero.
__device__ __forceinline__ void nonzero_range(const uint4& v, int base, int* lo, int* hi) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if ((w[e / 2] >> (16 * (e % 2))) & 0x7fffu) {
      *lo = min(*lo, base + e);
      *hi = max(*hi, base + e);
    }
  }
}

template <typename OutT>
__device__ __forceinline__ void store1(OutT* p, float v);
template <>
__device__ __forceinline__ void store1<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store1<bf16>(bf16* p, float v) { *p = __float2bfloat16_rn(v); }


template <int V, int BK, typename OutT>
__global__ void __launch_bounds__(kThreads, BK == 8 ? 2 : 1)
    roi_stage2_kernel(const bf16* __restrict__ f, const bf16* __restrict__ wy,
                      const bf16* __restrict__ wx, OutT* __restrict__ out, int K, int Kp, int C,
                      int hp, int wp) {
  constexpr int kRows = BK * kOut;            // Wy rows (i, oy) = block-diagonal Wx rows (i, ox)
  constexpr int kMPad = round16(kRows);
  constexpr int kMTiles = kMPad / 16;
  constexpr bool kPerOy = V == kRetile;
  constexpr bool kBlockDiag = V == kRetile || V == kTranspose;
  constexpr int kS1Tiles = kPerOy ? 1 : kMTiles;   // stage-1 row tiles per pass
  constexpr int kPasses = kPerOy ? kOut : 1;
  // stage 2: dotswap/noxpose own (i, oy) tiles; the block-diagonal forms own
  // (row tile, column tile) pairs, columns (oy, channel half) or, per oy, the
  // channel half
  constexpr int kNT = kPerOy ? 2 : 2 * kOut;
  constexpr int kPairs = kBlockDiag ? kMTiles * kNT : kRows;
  constexpr int kPerWarp = (kPairs + kWarps - 1) / kWarps;

  extern __shared__ __align__(16) unsigned char smem[];
  int* range = reinterpret_cast<int*>(smem);                  // h lo, h hi, w lo, w hi
  bf16* wy_s = reinterpret_cast<bf16*>(smem + 16);
  const int wy_row = hp + 8;
  bf16* wx_s = wy_s + kMPad * wy_row;                          // [i][ox 0..7][w]
  const int wx_row = wp + 8;
  bf16* f_s = wx_s + BK * kOxPad * wx_row;                     // kStages x [h][w][c]
  bf16* t_s = f_s + kStages * kHt * kFRow;                     // [row][w][c]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * kCs;
  const int k0 = blockIdx.y * BK;
  const int b = blockIdx.z;

  // 1. Wy and Wx into shared memory, with the ranges of their nonzero columns.
  if (tid < 4) range[tid] = (tid % 2 == 0) ? INT_MAX : -1;
  __syncthreads();
  int hlo = INT_MAX, hhi = -1, wlo = INT_MAX, whi = -1;
  const bf16* wy_g = wy + (static_cast<size_t>(b) * Kp + k0) * kOut * hp;
  const int wy_chunks = hp / 8;
  for (int q = tid; q < kMPad * wy_chunks; q += kThreads) {
    const int r = q / wy_chunks, ch = q % wy_chunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    int srow = r;
    if (r < kRows) {
      v = *reinterpret_cast<const uint4*>(wy_g + static_cast<size_t>(r) * hp + ch * 8);
      nonzero_range(v, ch * 8, &hlo, &hhi);
      if (kPerOy) srow = (r % kOut) * BK + r / kOut;          // rows in (oy, i) order
    }
    *reinterpret_cast<uint4*>(wy_s + srow * wy_row + ch * 8) = v;
  }
  const bf16* wx_g = wx + (static_cast<size_t>(b) * Kp + k0) * kOut * wp;
  const int wx_chunks = wp / 8;
  for (int q = tid; q < BK * kOxPad * wx_chunks; q += kThreads) {
    const int r = q / wx_chunks, ch = q % wx_chunks;
    const int i = r / kOxPad, ox = r % kOxPad;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ox < kOut) {
      v = *reinterpret_cast<const uint4*>(wx_g + static_cast<size_t>(i * kOut + ox) * wp +
                                          ch * 8);
      nonzero_range(v, ch * 8, &wlo, &whi);
    }
    *reinterpret_cast<uint4*>(wx_s + r * wx_row + ch * 8) = v;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    hlo = min(hlo, __shfl_xor_sync(0xffffffffu, hlo, s));
    hhi = max(hhi, __shfl_xor_sync(0xffffffffu, hhi, s));
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, s));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, s));
  }
  if (lane == 0) {
    atomicMin(&range[0], hlo);
    atomicMax(&range[1], hhi);
    atomicMin(&range[2], wlo);
    atomicMax(&range[3], whi);
  }
  __syncthreads();
  const bool empty = range[1] < 0 || range[3] < 0;
  const int ht0 = empty ? 0 : range[0] / kHt;
  const int n_ht = empty ? 0 : range[1] / kHt - ht0 + 1;
  const int wt0 = empty ? 0 : range[2] / kWt;
  const int n_wt = empty ? 0 : range[3] / kWt - wt0 + 1;
  const int steps = n_ht * n_wt;

  const bf16* f_img = f + static_cast<size_t>(b) * hp * wp * C + c0;
  auto load_f = [&](int s) {
    bf16* dst = f_s + (s % kStages) * kHt * kFRow;
    const int wt = wt0 + s / n_ht, ht = ht0 + s % n_ht;
    for (int q = tid; q < kHt * kWt * 2; q += kThreads) {
      const int hh = q / (2 * kWt), ww = (q / 2) % kWt, half = q % 2;
      const bf16* src =
          f_img + (static_cast<size_t>(ht * kHt + hh) * wp + wt * kWt + ww) * C + half * 8;
      cp_async16(dst + hh * kFRow + ww * kCs + half * 8, src);
    }
  };

  const int mat = lane >> 3, mrow = lane & 7;   // ldmatrix: this lane's matrix and row
  for (int pass = 0; pass < kPasses; ++pass) {
    float acc1[kS1Tiles][4][4];
    float acc2[kPerWarp][4];
#pragma unroll
    for (int m = 0; m < kS1Tiles; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[m][j][e] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPerWarp; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[p][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) load_f(s);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (s + kStages - 1 < steps) load_f(s + kStages - 1);
      cp_async_commit();

      // 2. Stage 1 on this F tile: this warp's 4 n8 tiles (w = 2 warp, 2 warp
      // + 1; channel halves) for every row tile.
      const bf16* fb = f_s + (s % kStages) * kHt * kFRow;
      const int ht = ht0 + s % n_ht;
      uint32_t bfrag[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        const int j = 4 * warp + 2 * p + (mat >> 1);
        ldsm_x4_trans(r, fb + (mrow + 8 * (mat & 1)) * kFRow + j * 8);
        bfrag[2 * p][0] = r[0];
        bfrag[2 * p][1] = r[1];
        bfrag[2 * p + 1][0] = r[2];
        bfrag[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int m = 0; m < kS1Tiles; ++m) {
        const int row = (kPerOy ? pass * BK : 0) + 16 * m + mrow + 8 * (mat & 1);
        uint32_t a[4];
        ldsm_x4(a, wy_s + row * wy_row + ht * kHt + 8 * (mat >> 1));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc1[m][j], a, bfrag[j][0], bfrag[j][1]);
      }
      if (s % n_ht != n_ht - 1) continue;

      // 3. The w tile's T, rounded to bf16 into shared memory, then stage 2.
#pragma unroll
      for (int m = 0; m < kS1Tiles; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int w = 2 * warp + (j >> 1), c = (j & 1) * 8 + 2 * t4;
          bf16* dst = t_s + (16 * m + g) * kTStride + w * kTRow + c;
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc1[m][j][0], acc1[m][j][1]);
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * kTStride) =
              __floats2bfloat162_rn(acc1[m][j][2], acc1[m][j][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc1[m][j][e] = 0.0f;
        }
      __syncthreads();
      const int wt = wt0 + s / n_ht;
      if constexpr (!kBlockDiag) {
        // A = T (rows: 16 channels at (i, oy); depth: w), B = Wx^T (ox)
#pragma unroll
        for (int p = 0; p < kPerWarp; ++p) {
          const int q = warp + kWarps * p;
          const int i = q / kOut;
          uint32_t a[4], b0, b1;
          ldsm_x4_trans(a, t_s + q * kTStride + (mrow + 8 * (mat >> 1)) * kTRow + 8 * (mat & 1));
          ldsm_x2(b0, b1, wx_s + (i * kOxPad + mrow) * wx_row + wt * kWt + 8 * (mat & 1));
          mma_bf16(acc2[p], a, b0, b1);
        }
      } else {
        // A = block-diagonal Wx (rows (i, ox)), B = T (depth (i', w); columns
        // channels at one oy); only the k tiles of the row tile's own ROIs
#pragma unroll
        for (int p = 0; p < kPerWarp; ++p) {
          const int pair = warp + kWarps * p;
          if (pair >= kPairs) break;
          const int mt = pair / kNT, nt = pair % kNT;
          const int oy = kPerOy ? pass : nt / 2, chalf = nt % 2;
          const int ra = 16 * mt + g, rb = ra + 8;
          const int ia = ra < kRows ? ra / kOut : -1, ib = rb < kRows ? rb / kOut : -1;
          const bf16* xa = wx_s + (max(ia, 0) * kOxPad + ra % kOut) * wx_row + wt * kWt + 2 * t4;
          const bf16* xb = wx_s + (max(ib, 0) * kOxPad + rb % kOut) * wx_row + wt * kWt + 2 * t4;
          const int i_lo = (16 * mt) / kOut, i_hi = min(16 * mt + 15, kRows - 1) / kOut;
          for (int ip = i_lo; ip <= i_hi; ++ip) {
            uint32_t a[4];
            a[0] = ia == ip ? *reinterpret_cast<const uint32_t*>(xa) : 0u;
            a[1] = ib == ip ? *reinterpret_cast<const uint32_t*>(xb) : 0u;
            a[2] = ia == ip ? *reinterpret_cast<const uint32_t*>(xa + 8) : 0u;
            a[3] = ib == ip ? *reinterpret_cast<const uint32_t*>(xb + 8) : 0u;
            const int trow = kPerOy ? ip : ip * kOut + oy;
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, t_s + trow * kTStride + (lane & 15) * kTRow + 8 * chalf);
            mma_bf16(acc2[p], a, b0, b1);
          }
        }
      }
    }

    // 4. Epilogue: only ROIs i < K.
    const size_t roi0 = static_cast<size_t>(b) * K;
    if constexpr (!kBlockDiag) {
#pragma unroll
      for (int p = 0; p < kPerWarp; ++p) {
        const int q = warp + kWarps * p;
        const int i = q / kOut, oy = q % kOut;
        if (k0 + i >= K) continue;
        const size_t base = (roi0 + k0 + i) * kOut + oy;   // (roi, oy)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + g + 8 * (e >> 1), ox = 2 * t4 + (e & 1);
          if (ox >= kOut) continue;
          const size_t idx = V == kNoxpose ? (base * C + c) * kOut + ox
                                           : (base * kOut + ox) * C + c;
          store1<OutT>(out + idx, acc2[p][e]);
        }
      }
    } else {
      static_assert(std::is_same<OutT, float>::value, "the block-diagonal forms store f32");
#pragma unroll
      for (int p = 0; p < kPerWarp; ++p) {
        const int pair = warp + kWarps * p;
        if (pair >= kPairs) break;
        const int mt = pair / kNT, nt = pair % kNT;
        const int oy = kPerOy ? pass : nt / 2, c = c0 + 8 * (nt % 2) + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mt + g + 8 * h;
          if (r >= kRows || k0 + r / kOut >= K) continue;
          const size_t idx = (((roi0 + k0 + r / kOut) * kOut + oy) * kOut + r % kOut) * C + c;
          *reinterpret_cast<float2*>(out + idx) =
              make_float2(acc2[p][2 * h], acc2[p][2 * h + 1]);
        }
      }
    }
    __syncthreads();
  }
}

template <int V, int BK, typename OutT>
int launch_one(const void* f, const void* wy, const void* wx, void* out, int B, int K, int Kp,
               int C, int hp, int wp, cudaStream_t stream) {
  const int smem = smem_bytes(V, BK, hp, wp);
  auto kernel = roi_stage2_kernel<V, BK, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(C / kCs), static_cast<unsigned>(Kp / BK),
                  static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(wy), static_cast<const bf16*>(wx),
      static_cast<OutT*>(out), K, Kp, C, hp, wp);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch(const void* f, const void* wy, const void* wx, void* out, int B, int K, int Kp, int C,
           int hp, int wp, int block_k, int out_bf16, void* stream) {
  if ((block_k != 8 && block_k != 16) || B < 0 || K < 0 || K > Kp || Kp % block_k ||
      C < kCs || C % kCs || hp < kHt || hp % kHt || wp < kWt || wp % kWt || B > 65535 ||
      smem_bytes(V, block_k, hp, wp) > kMaxSmem || (out_bf16 && V != kNoxpose)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Kp == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (V == kNoxpose) {    // the only variant with a bf16 output
    if (out_bf16) {
      return block_k == 8 ? launch_one<V, 8, bf16>(f, wy, wx, out, B, K, Kp, C, hp, wp, st)
                          : launch_one<V, 16, bf16>(f, wy, wx, out, B, K, Kp, C, hp, wp, st);
    }
  }
  return block_k == 8 ? launch_one<V, 8, float>(f, wy, wx, out, B, K, Kp, C, hp, wp, st)
                      : launch_one<V, 16, float>(f, wy, wx, out, B, K, Kp, C, hp, wp, st);
}

}  // namespace

// f (B, Hp, Wp, C), wy (B, Kp, 7, Hp), wx (B, Kp, 7, Wp): bf16, contiguous;
// out (B, K, 7, 7, C), or (B, K, 7, C, 7) for noxpose, f32 or (out_bf16,
// noxpose only) bf16.
#define M2DE_STAGE2_ENTRY(name, variant)                                                   \
  extern "C" int name(const void* f, const void* wy, const void* wx, void* out, int B,     \
                      int K, int Kp, int C, int hp, int wp, int block_k, int out_bf16,     \
                      void* stream) {                                                      \
    return launch<variant>(f, wy, wx, out, B, K, Kp, C, hp, wp, block_k, out_bf16, stream); \
  }

// native.py compiles this source once per entry, with -DM2DE_STAGE2_VARIANT=1
// or 2 (one nvcc each, in parallel); without the macro one object holds both.
#if !defined(M2DE_STAGE2_VARIANT) || M2DE_STAGE2_VARIANT == 1
M2DE_STAGE2_ENTRY(m2de_roi_stage2_transpose, kTranspose)

extern "C" int m2de_roi_stage2_resident_smem_bytes(int hp, int wp);

// Shared-memory bytes of one block (variant: 0 retile, 1 transpose, 2
// dotswap, 3 noxpose), as ops/roi_stage2_kernel.py:launch_plan computes them;
// retile and noxpose from roi_stage2_resident.cu.
extern "C" int m2de_roi_stage2_smem_bytes(int variant, int block_k, int hp, int wp) {
  if (variant == kRetile || variant == kNoxpose) return m2de_roi_stage2_resident_smem_bytes(hp, wp);
  return smem_bytes(variant, block_k, hp, wp);
}
#endif
#if !defined(M2DE_STAGE2_VARIANT) || M2DE_STAGE2_VARIANT == 2
M2DE_STAGE2_ENTRY(m2de_roi_stage2_dotswap, kDotswap)
#endif
