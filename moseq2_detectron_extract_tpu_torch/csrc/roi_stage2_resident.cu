// The four stage-2 layouts of the fused separable ROIAlign on Hopper's
// tensor cores (sm_90a, mma.sync.m16n8k16 bf16 with f32 accumulators), on one
// loop that keeps an image's pyramid channel slice resident in shared memory.
//
// Replaces the Pallas TPU kernel bodies of benchmarks/roi_stage2_exp.py,
// launched by its make_variant:
//   m2de_roi_stage2_retile     <- _kernel_retile_peroy (l.59)
//   m2de_roi_stage2_transpose  <- _kernel_transpose    (l.92)
//   m2de_roi_stage2_dotswap    <- _kernel_dotswap      (l.114)
//   m2de_roi_stage2_noxpose    <- _kernel_noxpose      (l.133)
//
// Function. All four compute the fused separable multilevel ROIAlign
//   T[i, oy, w, c]  = bf16( sum_h Wy[i, oy, h] * F[h, w, c] )        (stage 1)
//   out[i, oy, ox, c] = sum_w Wx[i, ox, w] * T[i, oy, w, c]           (stage 2)
// with F the H-stacked, W-padded pyramid of one image (bf16), Wy and Wx the
// folded interpolation weights rounded to bf16, both stages accumulated in
// f32 and T rounded to bf16 between them, as the TPU's bf16 t_vmem is.
// noxpose writes (i, oy, c, ox) in f32 or bf16, the others (i, oy, ox, c) in
// f32. Only ROIs i < K are written (the wrapper pads the ROIs to a multiple
// of block_k with zero weights, as make_variant does).
//
// Layout (ops/roi_stage2_kernel.py builds it): F (B, Hp, Wp, C), Wy (B, Kp, 7,
// Hp), Wx (B, Kp, 7, Wp), bf16, contiguous; Hp and Wp are sum_l H_l and
// max_l W_l padded with zeros to the mma depth of 16, Kp a multiple of
// block_k (8 or 16). The output size is 7.
//
// What bounds it on an H100. The function moves bytes: the taps its boxes
// touch, 32 fp32 operations per output element (PERF.md, row 1). This dense
// form does far more work: stage 1 multiplies every row of the ROIs' level
// bands. A loop that streamed F tiles from L2 through a cp.async ring
// issued its mma at about a tenth of the tensor-core peak: every warp waited
// on a cp.async group and a block barrier behind every 16 mma. Like the TPU
// kernel, which copies one image's pyramid into VMEM once (at kb == 0) and
// reads it there for every ROI block of the image, this loop loads F once per
// image: each block holds one (image, slice of cs channels) and its F slice,
// (Hp, Wp, cs) bf16, stays in shared memory while the block walks every ROI
// of the image. The slice takes most of the shared memory, so an SM holds one
// block of 8 warps; what bounds the loop is then latency inside each warp
// (PERF.md, section 6), and the design keeps each warp's chains short and its
// warps apart: after the F slice has landed no warp waits for another, loads
// run a step ahead of the mma that read them, and shared-memory loads are
// batched.
//
// Design. One block of 8 warps per (channel slice, image); cs is 16 where the
// slice and the warps' buffers fit in 232,448 bytes, else 8 (the
// experiment's Hp 128 x Wp 64: 219,264 bytes at cs 8).
// 1. The F slice is copied into shared memory once (cp.async, 16 bytes a
//    thread), as cs / 8 planes of (h, w, 8 channels), each h row padded by
//    16 bytes so ldmatrix reads no bank twice. This is the only time the
//    block meets.
// 2. Each warp walks pairs of the image's ROIs on its own (pairs warp,
//    warp + 8, ...), whatever block_k is (block_k only sets make_variant's
//    ROI padding). It copies the pair's 14 Wy and 14 Wx rows with bulk
//    copies (the TMA unit) counted on its mbarrier, into rows (i, oy) and (i,
//    ox) with oy and ox padded to 8 by a zero row, so a pair's rows are one
//    m16 tile; the next pair's copies start as soon as this pair's weights
//    are read, and run under the epilogue. It then finds the h and w tiles of
//    16 where the pair's weights are nonzero; the tiles outside are skipped
//    (the result is the same), inside them stage 1 is dense.
// 3. Stage 1, the same for all four, runs over the (w tile, h tile) steps
//    as one loop reading only shared memory (Wy rows by ldmatrix, F by
//    ldmatrix.trans; per step 16 n8 tiles, 16 w columns of 8 channels), its
//    fragments loaded a step ahead, with no barrier and no copy to wait for.
//    At the end of a w tile the accumulators, rounded to bf16, go into the
//    warp's T tile (16 rows x 16 w x 8 channels, 16-byte chunks
//    XOR-swizzled by row), after stage 2 of the previous w tile has read it
//    while these mma drain. With cs 16 a warp walks each pair once per
//    8-channel half. It runs once over all rows (i, oy): with T a w tile at
//    a time there is no reason to repeat it per oy, so the four variants
//    issue the same stage-1 mma at both block_k
//    (roi_stage2_kernel.mma_count).
// 4. Stage 2, its accumulators in registers across the w tiles:
//    - dotswap, noxpose: A = T with rows (oy pair, 8 channels) and depth w
//      (ldmatrix.trans; the pair (6, 7) has T's zero row oy 7 as its second
//      half), B = Wx^T with N = ox (7 padded to 8): 4 mma per ROI and w
//      tile. They issue the same mma in the same order and differ only in
//      the epilogue, so dotswap's output is noxpose's with (c, ox) swapped,
//      bit for bit.
//    - retile: the TPU body's block-diagonal per-oy product. For each oy, A
//      = the block-diagonal Wx of the pair's two ROIs, rows (i, ox), depth
//      (i', w); B = T at that oy, depth (i', w), N = 8 channels: 2 mma per
//      oy (one k tile per ROI; no other ROI's zero block is multiplied),
//      its B fragments by two ldmatrix.x2.trans per oy.
//    - transpose: the same block-diagonal A against B = T with N = (oy, c),
//      all 7 oy in one product. Its B fragments come over oy pairs, one
//      ldmatrix.x4.trans per pair and ROI (the pair (6, 7) reads the zero
//      row oy 7, whose n8 tile is not multiplied): 8 loads per w tile where
//      retile issues 14. The mma are retile's, 14 per w tile, each
//      accumulator (oy) summed in the same order, so transpose's output is
//      retile's bit for bit. On the TPU the two split because of Mosaic's
//      relayout limits; on Hopper only the B loads differ.
// 5. Epilogue, only ROIs k < K:
//    - noxpose stages each (i, oy) row of (8 channels x 7 ox) values in the
//      T tile and writes it with one bulk store, contiguous in the output
//      (224 bytes f32, 112 bf16), where a direct store would write 4 bytes
//      at a stride of 7.
//    - retile, transpose and dotswap write (i, oy, ox, c): a block's 8
//      channels of one (i, oy, ox) are a 32-byte piece, pieces C x 4 bytes
//      apart. One epilogue serves the three: the pair's 98 pieces are staged
//      in the T tile as (i, oy, ox, 8 channels) and written with 16-byte
//      stores, two lanes a piece, whichever accumulator layout they came
//      from ((i, ox) x channels for retile and transpose, (oy, channel) x ox
//      for dotswap).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kOut = 7;                  // output size
constexpr int kCu = 8;                   // channels per T column and F plane
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTBuf = 16 * 16 * kCu;     // a warp's T tile: 16 rows x 16 w x 8 c
constexpr int kHead = 128;               // bytes: the warps' mbarriers, and room
constexpr int kMaxSmem = 232448;         // bytes of shared memory a block may use

enum Variant { kRetile = 0, kTranspose = 1, kDotswap = 2, kNoxpose = 3 };

int resident_bytes(int cs, int hp, int wp) {
  return kHead + 2 * (cs / kCu * hp * (wp * kCu + 8) + kWarps * 16 * (hp + 8 + wp + 8) +
                      kWarps * kTBuf);
}

int resident_cs(int hp, int wp) { return resident_bytes(16, hp, wp) <= kMaxSmem ? 16 : 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

// The barrier expects `bytes` more bytes of bulk copies in its current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// One bulk copy (the TMA unit) of `bytes` contiguous bytes into shared
// memory, its completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One bulk copy of `bytes` contiguous bytes from shared to global memory, in
// this thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

// Element offset of (row, w) in a warp's T tile: rows of 16 w x 8 channels,
// the 16-byte chunk of w XOR-swizzled by the row so that the 8 rows a warp
// writes at one w, and the 8 w ldmatrix reads at one row, hit 8 bank groups.
__device__ __forceinline__ int tidx(int row, int w) { return (row * 16 + (w ^ (row & 7))) * kCu; }

template <int V, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    roi_stage2_resident_kernel(const bf16* __restrict__ f, const bf16* __restrict__ wy,
                               const bf16* __restrict__ wx, OutT* __restrict__ out, int K,
                               int Kp, int C, int hp, int wp, int cs) {
  static_assert(V == kNoxpose || std::is_same<OutT, float>::value, "only noxpose stores bf16");
  constexpr bool kBlockDiag = V == kRetile || V == kTranspose;   // stage 2's A is Wx
  extern __shared__ __align__(16) unsigned char smem[];
  const int f_row = wp * kCu + 8;                            // one h row of an F plane
  const int f_plane = hp * f_row;
  const int wy_row = hp + 8, wx_row = wp + 8;
  bf16* f_s = reinterpret_cast<bf16*>(smem + kHead);         // [cs / 8][h][w][8 c]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;                // ldmatrix: this lane's matrix, row
  const int b = blockIdx.z;
  const int cbase = blockIdx.x * cs;
  const int wy_chunks = hp / 8, chunks = hp / 8 + wp / 8;    // 16-byte chunks of a weight row
  // This warp's own shared memory: its mbarrier, its two ROIs' Wy and Wx rows
  // (i * 8 + oy, oy = 7 a zero row) and its T tile.
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp;
  bf16* wyw = f_s + cs / kCu * f_plane + warp * 16 * wy_row;
  bf16* wxw = f_s + cs / kCu * f_plane + kWarps * 16 * wy_row + warp * 16 * wx_row;
  bf16* tw = f_s + cs / kCu * f_plane + kWarps * 16 * (wy_row + wx_row) + warp * kTBuf;
  // Chunk ch of row r: the Wy row's chunks, then the Wx row's.
  auto chunk = [&](int r, int ch) -> bf16* {
    return ch < wy_chunks ? wyw + r * wy_row + ch * 8 : wxw + r * wx_row + (ch - wy_chunks) * 8;
  };

  // The zero rows oy = 7 and ox = 7 (the copies never write them).
  for (int ch = lane; ch < chunks; ch += 32) {
    *reinterpret_cast<uint4*>(chunk(7, ch)) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(chunk(15, ch)) = make_uint4(0, 0, 0, 0);
  }
  if (lane == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // 2. The weights of ROI pair q (ROIs 2q, 2q + 1): 28 rows by 28 bulk
  // copies (one lane each), counted on the warp's mbarrier; 16-byte cp.async
  // copies by every lane took longer (PERF.md, section 6).
  auto load_weights = [&](int q) {
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, 2 * kOut * (hp + wp) * 2);
    }
    __syncwarp();
    if (lane < 4 * kOut) {
      const int i = lane / (2 * kOut), oy = (lane % (2 * kOut)) / 2;
      const size_t row = (static_cast<size_t>(b) * Kp + 2 * q + i) * kOut + oy;
      if (lane % 2 == 0) {
        bulk_copy(wyw + (i * 8 + oy) * wy_row, wy + row * hp, hp * 2, bar);
      } else {
        bulk_copy(wxw + (i * 8 + oy) * wx_row, wx + row * wp, wp * 2, bar);
      }
    }
  };
  if (warp < Kp / 2) load_weights(warp);

  // 1. The F slice, once, the only time the block meets.
  const bf16* f_img = f + static_cast<size_t>(b) * hp * wp * C + cbase;
  for (int r = warp; r < cs / kCu * hp; r += kWarps) {
    const int plane = r / hp, h = r % hp;
    for (int w = lane; w < wp; w += 32)
      cp_async16(f_s + plane * f_plane + h * f_row + w * kCu,
                 f_img + static_cast<size_t>(h * wp + w) * C + plane * kCu);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // Each warp walks ROI pairs warp, warp + 8, ... on its own.
  for (int q = warp, it = 0; q < Kp / 2; q += kWarps, ++it) {
    mbar_wait(bar, it & 1);

    // The h and w tiles (of 16) where the pair weighs anything.
    int hlo = INT_MAX, hhi = -1, wlo = INT_MAX, whi = -1;
    for (int ch = lane; ch < chunks; ch += 32) {
      // each ROI's 7 rows at once, so that one shared-memory latency covers them
      uint32_t any = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint4 v[kOut];
#pragma unroll
        for (int oy = 0; oy < kOut; ++oy)
          v[oy] = *reinterpret_cast<const uint4*>(chunk(i * 8 + oy, ch));
#pragma unroll
        for (int oy = 0; oy < kOut; ++oy) any |= v[oy].x | v[oy].y | v[oy].z | v[oy].w;
      }
      if (!(any & 0x7fff7fffu)) continue;    // no bf16 of the chunk's column is nonzero
      if (ch < wy_chunks) {
        hlo = min(hlo, ch / 2);
        hhi = max(hhi, ch / 2);
      } else {
        wlo = min(wlo, (ch - wy_chunks) / 2);
        whi = max(whi, (ch - wy_chunks) / 2);
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      hlo = min(hlo, __shfl_xor_sync(0xffffffffu, hlo, s));
      hhi = max(hhi, __shfl_xor_sync(0xffffffffu, hhi, s));
      wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, s));
      whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, s));
    }
    const bool empty = hhi < 0 || whi < 0;
    const int ht0 = empty ? 0 : hlo, ht1 = empty ? 0 : hhi + 1;
    const int wt0 = empty ? 0 : wlo, wt1 = empty ? 0 : whi + 1;

    for (int half = 0; half < cs / kCu; ++half) {
      if constexpr (V == kNoxpose) {
        bulk_wait_read();        // the last output rows have left the T tile
        __syncwarp();
      }
      const bf16* fb = f_s + half * f_plane;
      const int c0 = cbase + half * kCu;
      // dotswap, noxpose: [ROI][oy pair]; retile, transpose: [oy] (of 7)
      float acc2[8][4];
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc2[p][e] = 0.0f;

      // Stage 2 (4. above) of w tile wt on the T tile: every fragment
      // first, then the mma.
      auto stage2 = [&](int wt) {
        if constexpr (!kBlockDiag) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t x0, x1, a[4][4];
            ldsm_x2(x0, x1, wxw + (i * 8 + mrow) * wx_row + wt * 16 + 8 * (mat & 1));
#pragma unroll
            for (int p = 0; p < 4; ++p)
              ldsm_x4_trans(a[p], tw + tidx(i * 8 + 2 * p + (mat & 1), mrow + 8 * (mat >> 1)));
#pragma unroll
            for (int p = 0; p < 4; ++p) mma_bf16(acc2[i * 4 + p], a[p], x0, x1);
          }
        } else {
          const bf16* x0 = wxw + g * wx_row + wt * 16 + 2 * t4;
          const bf16* x1 = x0 + 8 * wx_row;
          // A: the block-diagonal Wx, its k tile of the first ROI, then the second
          const uint32_t xa[4] = {*reinterpret_cast<const uint32_t*>(x0), 0u,
                                  *reinterpret_cast<const uint32_t*>(x0 + 8), 0u};
          const uint32_t xb[4] = {0u, *reinterpret_cast<const uint32_t*>(x1), 0u,
                                  *reinterpret_cast<const uint32_t*>(x1 + 8)};
          // B at oy: [0..1] the first ROI's T rows, [2..3] the second's
          uint32_t bt[8][4];
          if constexpr (V == kRetile) {
#pragma unroll
            for (int oy = 0; oy < kOut; ++oy) {
              ldsm_x2_trans(bt[oy][0], bt[oy][1], tw + tidx(oy, lane & 15));
              ldsm_x2_trans(bt[oy][2], bt[oy][3], tw + tidx(8 + oy, lane & 15));
            }
          } else {
            // one x4 per (ROI, oy pair): lanes 16-31 address the pair's second oy
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                uint32_t r[4];
                ldsm_x4_trans(r, tw + tidx(i * 8 + 2 * p + (lane >> 4), lane & 15));
                bt[2 * p][2 * i] = r[0];
                bt[2 * p][2 * i + 1] = r[1];
                bt[2 * p + 1][2 * i] = r[2];
                bt[2 * p + 1][2 * i + 1] = r[3];
              }
          }
#pragma unroll
          for (int oy = 0; oy < kOut; ++oy) {
            mma_bf16(acc2[oy], xa, bt[oy][0], bt[oy][1]);
            mma_bf16(acc2[oy], xb, bt[oy][2], bt[oy][3]);
          }
        }
      };

      // 3. Stage 1: rows (i, oy) of the pair x the 16 w columns of each w
      // tile, 8 channels each, over the h range, from shared memory only.
      // The (w tile, h tile) steps run as one loop whose fragments are loaded
      // a step ahead, in two register sets, so that ldmatrix's latency
      // overlaps the mma, across the end of a w tile too.
      float acc1[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[j][e] = 0.0f;
      const bf16* fcol = fb + (mrow + 8 * (mat & 1)) * f_row + (mat >> 1) * kCu;
      const bf16* arow = wyw + (mrow + 8 * (mat & 1)) * wy_row + 8 * (mat >> 1);
      int lw = wt0, lh = ht0;    // the next step to load
      auto load = [&](uint32_t (&a)[4], uint32_t (&bq)[8][4]) {
        ldsm_x4(a, arow + lh * 16);
        const bf16* fp = fcol + lh * 16 * f_row + lw * 16 * kCu;
#pragma unroll
        for (int j = 0; j < 8; ++j) ldsm_x4_trans(bq[j], fp + 2 * j * kCu);
        if (++lh == ht1) {
          lh = ht0;
          ++lw;
        }
      };
      auto mma16 = [&](const uint32_t (&a)[4], const uint32_t (&bq)[8][4]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mma_bf16(acc1[2 * j], a, bq[j][0], bq[j][1]);
          mma_bf16(acc1[2 * j + 1], a, bq[j][2], bq[j][3]);
        }
      };
      // The end of w tile wt: stage 2 of the previous w tile while these mma
      // drain, then this tile's T, rounded to bf16, in the same buffer.
      auto end_tile = [&](int wt) {
        if (wt > wt0) stage2(wt - 1);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(tw + tidx(g, j) + 2 * t4) =
              __floats2bfloat162_rn(acc1[j][0], acc1[j][1]);
          *reinterpret_cast<__nv_bfloat162*>(tw + tidx(g + 8, j) + 2 * t4) =
              __floats2bfloat162_rn(acc1[j][2], acc1[j][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc1[j][e] = 0.0f;
        }
        __syncwarp();
      };
      const int steps = (ht1 - ht0) * (wt1 - wt0);
      uint32_t a0[4], b0[8][4], a1[4], b1[8][4];
      if (steps > 0) load(a0, b0);
      int cw = wt0, ch = ht0;    // the step being computed
      for (int step = 0; step < steps; step += 2) {
        if (step + 1 < steps) load(a1, b1);
        mma16(a0, b0);
        if (++ch == ht1) {
          ch = ht0;
          end_tile(cw++);
        }
        if (step + 1 >= steps) break;
        if (step + 2 < steps) load(a0, b0);
        mma16(a1, b1);
        if (++ch == ht1) {
          ch = ht0;
          end_tile(cw++);
        }
      }
      if (wt1 > wt0) stage2(wt1 - 1);
      __syncwarp();
      // the pair's weights are read: the next pair's may come in
      if (half == cs / kCu - 1 && q + kWarps < Kp / 2) load_weights(q + kWarps);

      // 5. Epilogue: only ROIs k < K.
      if constexpr (V == kNoxpose) {
        // Each (i, oy) row of (8 channels x 7 ox) values through the T tile,
        // then one bulk store (the TMA unit) per row, 224 contiguous bytes
        // (112 in bf16) of the output.
        OutT* st = reinterpret_cast<OutT*>(tw);
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = p / 4, oy = 2 * (p % 4) + (e >> 1), ox = 2 * t4 + (e & 1);
            if (oy >= kOut || ox >= kOut) continue;
            OutT* dst = st + (i * kOut + oy) * 8 * kOut + g * kOut + ox;
            if constexpr (std::is_same<OutT, float>::value) {
              *dst = acc2[p][e];
            } else {
              *dst = __float2bfloat16_rn(acc2[p][e]);
            }
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        const int i = lane / kOut, oy = lane % kOut;
        if (lane < 2 * kOut && 2 * q + i < K) {
          const size_t row = (static_cast<size_t>(b) * K + 2 * q + i) * kOut + oy;
          bulk_store(out + (row * C + c0) * kOut, st + (i * kOut + oy) * 8 * kOut,
                     8 * kOut * sizeof(OutT));
        }
      } else {
        // The pair's 98 (i, oy, ox) pieces of 8 channels (32 bytes) staged in
        // the T tile, then 16-byte stores, two lanes a piece.
        float* st = reinterpret_cast<float*>(tw);
        if constexpr (kBlockDiag) {    // rows (i, ox = g), columns channels 2 t4, 2 t4 + 1
#pragma unroll
          for (int oy = 0; oy < kOut; ++oy)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (g < kOut)
                *reinterpret_cast<float2*>(st + ((i * kOut + oy) * kOut + g) * kCu + 2 * t4) =
                    make_float2(acc2[oy][2 * i], acc2[oy][2 * i + 1]);
        } else {                       // rows (oy, channel g), columns ox 2 t4, 2 t4 + 1
#pragma unroll
          for (int p = 0; p < 8; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = p / 4, oy = 2 * (p % 4) + (e >> 1), ox = 2 * t4 + (e & 1);
              if (oy < kOut && ox < kOut) st[((i * kOut + oy) * kOut + ox) * kCu + g] = acc2[p][e];
            }
        }
        __syncwarp();
        const size_t piece0 = (static_cast<size_t>(b) * K + 2 * q) * kOut * kOut;
        const int pieces = min(2, K - 2 * q) * kOut * kOut;
        for (int j = lane; j < 2 * pieces; j += 32)
          *reinterpret_cast<float4*>(out + (piece0 + j / 2) * C + c0 + 4 * (j & 1)) =
              *reinterpret_cast<const float4*>(st + 4 * j);
      }
    }
  }
  if (V == kNoxpose) bulk_wait_read();
}

template <int V, typename OutT>
int launch_one(const void* f, const void* wy, const void* wx, void* out, int B, int K, int Kp,
               int C, int hp, int wp, cudaStream_t stream) {
  const int cs = resident_cs(hp, wp);
  const int smem = resident_bytes(cs, hp, wp);
  auto kernel = roi_stage2_resident_kernel<V, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(C / cs), 1, static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(wy), static_cast<const bf16*>(wx),
      static_cast<OutT*>(out), K, Kp, C, hp, wp, cs);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch(const void* f, const void* wy, const void* wx, void* out, int B, int K, int Kp, int C,
           int hp, int wp, int block_k, int out_bf16, void* stream) {
  if ((block_k != 8 && block_k != 16) || B < 0 || K < 0 || K > Kp || Kp % block_k || C < 16 ||
      C % 16 || hp < 16 || hp % 16 || wp < 16 || wp % 16 || B > 65535 ||
      resident_bytes(resident_cs(hp, wp), hp, wp) > kMaxSmem || (out_bf16 && V != kNoxpose)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Kp == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (V == kNoxpose) {    // the only variant with a bf16 output
    if (out_bf16) return launch_one<V, bf16>(f, wy, wx, out, B, K, Kp, C, hp, wp, st);
  }
  return launch_one<V, float>(f, wy, wx, out, B, K, Kp, C, hp, wp, st);
}

}  // namespace

// f (B, Hp, Wp, C), wy (B, Kp, 7, Hp), wx (B, Kp, 7, Wp): bf16, contiguous;
// out (B, K, 7, 7, C), or (B, K, 7, C, 7) for noxpose, f32 or (out_bf16,
// noxpose only) bf16.
#define M2DE_RESIDENT_ENTRY(name, variant)                                                 \
  extern "C" int name(const void* f, const void* wy, const void* wx, void* out, int B,     \
                      int K, int Kp, int C, int hp, int wp, int block_k, int out_bf16,     \
                      void* stream) {                                                      \
    return launch<variant>(f, wy, wx, out, B, K, Kp, C, hp, wp, block_k, out_bf16, stream); \
  }

// native.py compiles this source once per entry, with -DM2DE_STAGE2_VARIANT=0,
// 1, 2 or 3 (one nvcc each, in parallel); without the macro one object holds
// all four.
#if !defined(M2DE_STAGE2_VARIANT) || M2DE_STAGE2_VARIANT == 0
M2DE_RESIDENT_ENTRY(m2de_roi_stage2_retile, kRetile)

// Channels per block and shared-memory bytes of one block, as
// ops/roi_stage2_kernel.py:launch_plan computes them (the bytes at cs 8 when
// nothing fits).
extern "C" int m2de_roi_stage2_resident_cs(int hp, int wp) { return resident_cs(hp, wp); }
extern "C" int m2de_roi_stage2_resident_smem_bytes(int hp, int wp) {
  return resident_bytes(resident_cs(hp, wp), hp, wp);
}
#endif
#if !defined(M2DE_STAGE2_VARIANT) || M2DE_STAGE2_VARIANT == 1
M2DE_RESIDENT_ENTRY(m2de_roi_stage2_transpose, kTranspose)
#endif
#if !defined(M2DE_STAGE2_VARIANT) || M2DE_STAGE2_VARIANT == 2
M2DE_RESIDENT_ENTRY(m2de_roi_stage2_dotswap, kDotswap)
#endif
#if !defined(M2DE_STAGE2_VARIANT) || M2DE_STAGE2_VARIANT == 3
M2DE_RESIDENT_ENTRY(m2de_roi_stage2_noxpose, kNoxpose)
#endif
