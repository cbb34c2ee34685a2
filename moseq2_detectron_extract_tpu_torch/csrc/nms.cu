// The NMS fixpoint (ops/nms.py:nms_keep_mask) for Hopper, sm_90a: one launch
// per call, the suppression rounds on the chip, no host sync.
//
// Replaces no TPU kernel: the JAX package's NMS
// (moseq2_detectron_extract_tpu/ops/nms.py:nms_keep_mask) is plain jnp, whose
// bounded while loop XLA keeps on the device. Added because the port's plain
// version, run eagerly, asks the host after every round whether a box is
// still undecided and builds (B, K, K) float and bool tensors: at the
// faithful model's proposal pool (B 50, K 3,008) it took 64% of a Predictor
// batch.
//
// Function, bit for bit as the plain version computes it. Box j dominates
// box i iff iou(i, j) > thr, j ranks before i (a higher score, or an equal
// score and a lower index) and valid[j]. The IoU takes ops/boxes.py's
// pairwise_iou and box_area operations in their order, each rounded on its
// own (the _rn intrinsics keep nvcc from contracting them into FMAs, so a
// pair at exactly the threshold falls the plain version's way), with
// torch.maximum / minimum / clamp's NaN propagation. Then, from keep = supp =
// 0, at most max_iters rounds of
//   keep |= valid & ~supp & ~any_j(dom[i, j] & ~supp[j])
//   supp |= any_j(dom[i, j] & keep[j])       (with the new keep)
// Each image stops at its own convergence (no valid box undecided), where
// the plain version tests the whole batch: a round after an image has
// converged changes nothing of its keep mask, so the answers are equal.
//
// What bounds it on an H100. The dominance relation needs an IoU for each
// pair of boxes (B K (K - 1) / 2: 2.3e8 at B 50, K 3,008), about 12 fp32
// operations each: 0.04 ms at 67e12 fp32 operations per second (the bound
// chip_smoke.py reports). Its bits (56.6 MB at that
// shape) and the rounds over them need never leave the chip; the bytes in
// and out are 3.3 MB (1 us at 3.35 TB/s). So the operations bound it.
//
// Design. One thread-block cluster per image, of C <= 16 CTAs chosen from K
// (launch_plan in ops/nms.py). CTA c owns the rows of words_per_cta 64-box
// blocks; a row of the relation is K bits (row_words 64-bit words, padded to
// an odd count so that a warp's 32 rows fall on distinct shared-memory
// banks), in the owner's shared memory. Each unordered pair of blocks is one
// tile, computed once by one of its two blocks (the nearer half of the ring
// of blocks ahead of it): a warp stages the tile's 64 column boxes in shared
// memory, takes its 32 rows against one column box at a time (a broadcast
// read), keeps both directions' bits, and at the end of the tile transposes
// the other direction's 32 x 64 bits by shuffles and sends each column's 32
// bits to the column's owner through distributed shared memory. The
// arithmetic is cut where the result cannot change: boxes all finite
// (checked per tile) take fminf / fmaxf, and the comparison with thr the
// fast division but near thr (iou_above_finite). Then the rounds run from
// shared memory:
// each thread decides one row's keep bit against the cluster's whole supp
// vector, a warp's 32 bits go by ballot to every CTA of the cluster, a
// cluster barrier, and the same for supp against the new keep. The vectors
// are double-buffered by the round's parity, so one barrier per half-round
// suffices, and every CTA holds them whole and so takes the same
// convergence decision. A row already decided (kept, or suppressed) is not
// scanned again. Where the slice of bits does not fit in shared memory (K
// above 5,056 at C = 16) the bits live in a device-memory scratch (L2 at
// the package's sizes), the same tiles and rounds: one algorithm, the bits'
// place taken from K.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;          // the most a block may take on an H100

typedef unsigned long long u64;

// torch.clamp(x, min=0), torch.maximum and torch.minimum: NaN propagates.
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a != a || a < b) ? a : b; }

__device__ __forceinline__ bool finite4(float4 q) {
  return isfinite(q.x) && isfinite(q.y) && isfinite(q.z) && isfinite(q.w);
}

__device__ __forceinline__ float box_area(float4 q) {
  return __fmul_rn(clamp0(__fsub_rn(q.z, q.x)), clamp0(__fsub_rn(q.w, q.y)));
}

// pairwise_iou(boxes, boxes)[i, j] > thr, in pairwise_iou's operations and
// order, for any coordinates and thr.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 q, float area_q,
                                          float thr) {
  const float w = clamp0(__fsub_rn(min_nan(a.z, q.z), max_nan(a.x, q.x)));
  const float h = clamp0(__fsub_rn(min_nan(a.w, q.w), max_nan(a.y, q.y)));
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_q), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, uni < 1e-9f ? 1e-9f : uni) : 0.f;
  return iou > thr;
}

// The same where both boxes' coordinates are finite and thr is in [2^-60,
// 2^60]. No operation then meets a NaN (a difference of finite floats
// overflows to an infinity, never to NaN), so the single-instruction fminf /
// fmaxf give torch's results. And the comparison RN(inter / u) > thr takes
// the fast division, within 2 ulps of the quotient q for u in [2^-126,
// 2^126]: a result above hi = thr (1 + 2^-20) puts q above thr's successor,
// one below lo = thr (1 - 2^-20) puts q below thr (each rounded to nearest).
// Only a quotient within about 2^-20 of thr (a few pairs in a million) takes
// the correctly rounded division, in a branch the whole warp skips when no
// lane needs it.
__device__ __forceinline__ bool iou_above_finite(float4 a, float area_a, float4 q, float area_q,
                                                 float thr, float lo, float hi) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, q.z), fmaxf(a.x, q.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, q.w), fmaxf(a.y, q.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_q), inter);
  const float u = fmaxf(uni, 1e-9f);
  float quot;
  asm("div.approx.ftz.f32 %0, %1, %2;" : "=f"(quot) : "f"(inter), "f"(u));
  bool over = uni > 0.f && quot > hi;
  const bool unsure = uni > 0.f && !over && (quot >= lo || !(u < 0x1p126f));
  if (__any_sync(~0u, unsure) && unsure) over = __fdiv_rn(inter, u) > thr;
  return over;
}

// One tile of the relation: 32 rows i (a warp's lanes, of the 64-box block
// I) against the n columns j of block J, whose boxes, scores and areas the
// warp staged in shared memory (cb, csa). mine: row i's word J, bit jj set iff
// box 64 J + jj dominates box i (valid[j] applied by the caller); theirs:
// bit jj set iff box i dominates box 64 J + jj (valid[i] applied).
template <bool kFinite>
__device__ __forceinline__ void tile(const float4* cb, const float2* csa, float4 a, float area_a,
                                     float s, int i, bool valid_i, int J, int n, float thr,
                                     float lo, float hi, u64& mine, u64& theirs) {
  mine = 0;
  theirs = 0;
  for (int jj = 0; jj < n; ++jj) {
    const int j = 64 * J + jj;
    const float4 q = cb[jj];
    const float2 sa = csa[jj];
    const bool over = kFinite ? iou_above_finite(a, area_a, q, sa.y, thr, lo, hi)
                              : iou_above(a, area_a, q, sa.y, thr);
    const bool tie = sa.x == s;
    if (over && (sa.x > s || (tie && j < i))) mine |= 1ull << jj;
    if (over && valid_i && (sa.x < s || (tie && i < j))) theirs |= 1ull << jj;
  }
}

// The transpose of the warp's 32 x 32 bit matrix (lane l's bit b becomes
// lane b's bit l): five rounds of swapping the off-diagonal blocks.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  const unsigned low[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const unsigned y = __shfl_xor_sync(~0u, x, s);
    x = (lane & s) ? (x & ~low[k]) | ((y & ~low[k]) >> s) : (x & low[k]) | ((y & low[k]) << s);
  }
  return x;
}

// Shared memory: valid, finite, keep[2], supp[2] (row_words each), each
// warp's staged column boxes and (score, area) pairs, then the bits.
constexpr int kStageBytes = kThreads / 32 * 64 * (16 + 8);
__host__ __device__ inline int smem_bytes(int row_words, int words_per_cta, bool bits_in_smem) {
  return 8 * 6 * row_words + kStageBytes +
         (bits_in_smem ? 8 * 64 * words_per_cta * row_words : 0);
}

template <bool kBitsInSmem>
__global__ void __launch_bounds__(kThreads, 2)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep_out,
           u64* __restrict__ scratch, int K, int words_per_cta, float thr, int max_iters) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y;
  const int W = (K + 63) / 64;
  const int ld = W | 1;
  const int lane = threadIdx.x & 31;
  const int w0 = c * words_per_cta;
  const int nw = min(words_per_cta, W - w0);
  const int rows = 64 * nw;
  const int row0 = 64 * w0;
  const size_t slice = static_cast<size_t>(64) * words_per_cta * ld;

  extern __shared__ u64 smem[];
  u64* vvalid = smem;
  u64* vfinite = smem + ld;
  u64* vkeep = smem + 2 * ld;             // parity p at vkeep + p * ld
  u64* vsupp = smem + 4 * ld;
  float4* stage = reinterpret_cast<float4*>(smem + 6 * ld) + (threadIdx.x >> 5) * 96;
  float2* stage_sa = reinterpret_cast<float2*>(stage + 64);
  u64* bits = kBitsInSmem ? smem + 6 * ld + kStageBytes / 8
                          : scratch + (static_cast<size_t>(b) * n_cta + c) * slice;

  const float4* bx = boxes + static_cast<size_t>(b) * K;
  const float* sc = scores + static_cast<size_t>(b) * K;
  const uint8_t* vb = valid + static_cast<size_t>(b) * K;

  for (int w = threadIdx.x >> 5; w < W; w += kThreads / 32) {
    const int j = 64 * w + lane;
    const unsigned lo = __ballot_sync(~0u, j < K && vb[j] != 0);
    const unsigned hi = __ballot_sync(~0u, j + 32 < K && vb[j + 32] != 0);
    const unsigned flo = __ballot_sync(~0u, j < K && finite4(__ldg(bx + j)));
    const unsigned fhi = __ballot_sync(~0u, j + 32 < K && finite4(__ldg(bx + j + 32)));
    if (lane == 0) {
      vvalid[w] = (static_cast<u64>(hi) << 32) | lo;
      vfinite[w] = (static_cast<u64>(fhi) << 32) | flo;
    }
  }
  for (int t = threadIdx.x; t < 4 * ld; t += kThreads) vkeep[t] = 0;   // keep[2], supp[2]
  // every CTA of the cluster has started, and its vectors are set, before
  // any CTA writes into its bits or vectors
  cluster.sync();

  // The relation, each unordered pair of 64-box blocks {I, J} once: block I
  // takes J = I + d (mod W) for d = 0 .. (W - 1) / 2, and d = W / 2 when W is
  // even and I < W / 2. A warp's lanes are 32 rows of block I (rows is a
  // multiple of 64), all against the same column box at a time.
  const bool finite_thr = thr >= 0x1p-60f && thr <= 0x1p60f;
  const float lo = thr * (1.f - 0x1p-20f);
  const float hi = thr * (1.f + 0x1p-20f);
  const int d_max = 1 + (W - 1) / 2 + (W % 2 == 0);
  unsigned* bits32 = reinterpret_cast<unsigned*>(bits);
  for (int t = threadIdx.x; t < nw * d_max * 64; t += kThreads) {
    const int lb = t / (d_max * 64);
    const int d = (t >> 6) - lb * d_max;
    const int I = w0 + lb;
    if (2 * d == W && 2 * I >= W) continue;            // the other block's tile
    const int J = I + d < W ? I + d : I + d - W;
    const int r = 64 * lb + (t & 63);
    const int i = row0 + r;
    const bool row_in = i < K;
    const float4 a = __ldg(bx + (row_in ? i : K - 1));
    const float area_a = box_area(a);
    const float s = __ldg(sc + (row_in ? i : K - 1));
    const bool valid_i = row_in && ((vvalid[I] >> (i & 63)) & 1);
    const int n = min(64, K - 64 * J);
    const u64 cols = n == 64 ? ~0ull : (1ull << n) - 1;
    // row j = 64 J + jj lives in CTA J / words_per_cta; its word I, half (i / 32) % 2
    const int cj = J / words_per_cta;
    unsigned* tr = nullptr;
    if (d != 0) {
      unsigned* owner = kBitsInSmem ? cluster.map_shared_rank(bits32, cj)
                                    : reinterpret_cast<unsigned*>(
                                          scratch + (static_cast<size_t>(b) * n_cta + cj) * slice);
      tr = owner + 2 * (static_cast<size_t>(64 * J - 64 * words_per_cta * cj) * ld + I) +
           ((i >> 5) & 1);
    }
    const bool fast = __all_sync(~0u, finite_thr && (vfinite[J] & cols) == cols &&
                                          (!row_in || ((vfinite[I] >> (i & 63)) & 1)));
    __syncwarp();                                      // the last tile's reads are done
    for (int x = lane; x < n; x += 32) {
      const float4 q = __ldg(bx + 64 * J + x);
      stage[x] = q;
      stage_sa[x] = make_float2(__ldg(sc + 64 * J + x), box_area(q));
    }
    __syncwarp();
    u64 mine, theirs;
    if (fast)
      tile<true>(stage, stage_sa, a, area_a, s, i, valid_i, J, n, thr, lo, hi, mine, theirs);
    else
      tile<false>(stage, stage_sa, a, area_a, s, i, valid_i, J, n, thr, lo, hi, mine, theirs);
    bits[static_cast<size_t>(r) * ld + J] = row_in ? mine & vvalid[J] : 0;
    if (d != 0) {
      // lane l now takes column jj = l (then 32 + l): its 32 bits "box i
      // dominates box j" over the warp's rows, row j's word I, half (i / 32) % 2
      for (int half = 0; half < 2; ++half) {
        const unsigned col = transpose32(static_cast<unsigned>(theirs >> (32 * half)), lane);
        if (32 * half + lane < n) tr[2 * ld * (32 * half + lane)] = col;
      }
    }
  }
  cluster.sync();

  int p = 0;
  for (int it = 0; it < max_iters; ++it) {
    const u64* keep = vkeep + p * ld;
    const u64* supp = vsupp + p * ld;
    int undecided = 0;
    for (int w = threadIdx.x; w < W; w += kThreads)
      undecided |= (vvalid[w] & ~keep[w] & ~supp[w]) != 0;
    if (!__syncthreads_or(undecided)) break;

    unsigned* keep_next = reinterpret_cast<unsigned*>(vkeep + (p ^ 1) * ld);
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int i = row0 + r;
      const u64 m = 1ull << (i & 63);
      bool k = (keep[i >> 6] & m) != 0;
      if (!k && !(supp[i >> 6] & m) && (vvalid[i >> 6] & m)) {
        const u64* row = bits + static_cast<size_t>(r) * ld;
        u64 any = 0;
        for (int w = 0; w < W && !any; ++w) any = row[w] & ~supp[w];
        k = any == 0;
      }
      const unsigned ballot = __ballot_sync(~0u, k);
      if (lane < n_cta) cluster.map_shared_rank(keep_next, lane)[i >> 5] = ballot;
    }
    cluster.sync();

    const u64* keep_new = vkeep + (p ^ 1) * ld;
    unsigned* supp_next = reinterpret_cast<unsigned*>(vsupp + (p ^ 1) * ld);
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int i = row0 + r;
      bool s = (supp[i >> 6] >> (i & 63)) & 1;
      if (!s && i < K) {               // a padding row's bits are not all written
        const u64* row = bits + static_cast<size_t>(r) * ld;
        u64 any = 0;
        for (int w = 0; w < W && !any; ++w) any = row[w] & keep_new[w];
        s = any != 0;
      }
      const unsigned ballot = __ballot_sync(~0u, s);
      if (lane < n_cta) cluster.map_shared_rank(supp_next, lane)[i >> 5] = ballot;
    }
    cluster.sync();
    p ^= 1;
  }

  const u64* keep = vkeep + p * ld;
  uint8_t* out = keep_out + static_cast<size_t>(b) * K;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int i = row0 + r;
    if (i < K) out[i] = static_cast<uint8_t>((keep[i >> 6] >> (i & 63)) & 1);
  }
}

template <bool kBitsInSmem>
cudaError_t configure(int cluster) {
  auto kernel = nms_kernel<kBitsInSmem>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B, int cluster,
                   int smem, void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, B, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <bool kBitsInSmem>
cudaError_t launch(const void* boxes, const void* scores, const void* valid, void* keep,
                   void* scratch, int B, int K, int cluster, int words_per_cta, float thr,
                   int max_iters, int smem, void* stream) {
  cudaError_t err = configure<kBitsInSmem>(cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, B, cluster, smem, stream);
  return cudaLaunchKernelEx(&cfg, nms_kernel<kBitsInSmem>, static_cast<const float4*>(boxes),
                            static_cast<const float*>(scores),
                            static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
                            static_cast<u64*>(scratch), K, words_per_cta, thr, max_iters);
}

// The plan's consistency: every word owned, no CTA empty, the shared memory
// within the card's limit.
bool plan_ok(int K, int cluster, int words_per_cta, int bits_in_smem) {
  if (K < 1 || cluster < 1 || cluster > kMaxCluster || words_per_cta < 1) return false;
  const int W = (K + 63) / 64;
  if (static_cast<long long>(cluster) * words_per_cta < W ||
      static_cast<long long>(cluster - 1) * words_per_cta >= W)
    return false;
  return 8 * 6LL * (W | 1) + kStageBytes +
             (bits_in_smem ? 8 * 64LL * words_per_cta * (W | 1) : 0) <=
         kMaxSmem;
}

}  // namespace

extern "C" int m2de_nms_keep_mask(const void* boxes, const void* scores, const void* valid,
                                  void* keep, void* scratch, int B, int K, int cluster,
                                  int words_per_cta, int bits_in_smem, float thr,
                                  int max_iters, void* stream) {
  if (B < 0 || K < 0 || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || K == 0) return 0;
  if (B > 65535 || !plan_ok(K, cluster, words_per_cta, bits_in_smem) ||
      (!bits_in_smem && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(((K + 63) / 64) | 1, words_per_cta, bits_in_smem != 0);
  const cudaError_t err =
      bits_in_smem ? launch<true>(boxes, scores, valid, keep, scratch, B, K, cluster,
                                  words_per_cta, thr, max_iters, smem, stream)
                   : launch<false>(boxes, scores, valid, keep, scratch, B, K, cluster,
                                   words_per_cta, thr, max_iters, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the plan the card can hold at once (0: none fits).
extern "C" int m2de_nms_max_active_clusters(int K, int cluster, int words_per_cta,
                                            int bits_in_smem, int* out) {
  if (!plan_ok(K, cluster, words_per_cta, bits_in_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(((K + 63) / 64) | 1, words_per_cta, bits_in_smem != 0);
  cudaError_t err = bits_in_smem ? configure<true>(cluster) : configure<false>(cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, 1, cluster, smem, nullptr);
  err = bits_in_smem ? cudaOccupancyMaxActiveClusters(out, nms_kernel<true>, &cfg)
                     : cudaOccupancyMaxActiveClusters(out, nms_kernel<false>, &cfg);
  return static_cast<int>(err);
}
