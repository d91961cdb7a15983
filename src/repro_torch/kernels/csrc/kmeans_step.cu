// kmeans_step: one k-means step, assignment and accumulation fused.
//
// Replaces src/repro/kernels/kmeans_step.py:kmeans_step_p.  That kernel ran
// both halves on the TPU's matrix unit: d² through an x·cᵀ product, and the
// accumulation as one_hot(labels)ᵀ·x, over blocks of 1024 points in order.
//
// Bound on the card: bytes.  The points are read once (n = 2^21, d = 8 per
// call of the k-means path: 67.1 MB, 20 µs at 3.35 TB/s); the n·k·(2d+3)
// f32 operations (0.64e9 a call at k = 16, 10 µs at 67 TFLOP/s outside the
// tensor cores) stay below that.
//
// Two routes, chosen by shape in kms_launch (kms_route), never on failure:
//
// * kms_tc, on the tensor cores, for d ≤ 32 and k ≤ 64 with KP·DP ≤ 512,
//   where KP is k rounded up to 16, 32 or 64 and DP is d rounded up to 8,
//   16 or 32: d ≤ 8 with k ≤ 64, d ≤ 16 with k ≤ 32, d ≤ 32 with k ≤ 16.
//   The k-means path (d = 8, k = 16) takes it.
// * kms_main, on the CUDA cores, for every other d ≤ 128 whose centroid
//   table fits in the opt-in shared memory (described at kms_main).
//
// kms_tc's design.  The tile ring, the one-hot product of the sums and
// the fixed-order finish are onehot.cuh's (shared with segsum.cu's seg_tc):
// a persistent grid of at most two blocks per SM (one where the registers
// need it; the caller passes the grid, kms_tc_grid), each of eight consumer
// warps and one producer warp that keeps six 16 KB tiles of points in
// flight as bulk copies.  Each consumer warp takes 1/8 of a tile, 16 points
// at a time:
//
// * distances on the tensor cores, mma.sync m16n8k8 in TF32 with a
//   three-way split: x = x_hi + x_lo and −2c = b_hi + b_lo, each hi
//   rounded as cvt.rna does, b_lo too, x_lo passed as the f32 rest (which
//   an mma reads as TF32 toward zero).  The score is ‖c_j‖² + x_lo·b_hi +
//   x_hi·b_lo + x_hi·b_hi, ‖c_j‖² (f32 fmas in index order) the first
//   product's addend; ‖x‖² is the same for every j and drops out of the
//   argmin.  The split's error: a rest v − hi lies on v's f32 grid with at
//   most 12 significant bits, so TF32 loses at most one f32 unit of v
//   (2^-23·|v|) whether it rounds or truncates; with the dropped
//   x_lo·b_lo (≤ 2^-22·|x_t·b_t|) a product x_t·b_t is off by at most
//   2^-21·|x_t·b_t|, a score by at most 2^-20·Σ_t|x_t·c_t| ≤
//   2^-21·(‖x‖² + ‖c_j‖²), before the f32 sums.  A label compares two
//   scores: at most 2^-20·(‖x‖² + max ‖c‖²) apart from their exact
//   difference by the split.  The tie margin of repro_torch/kmeans.py,
//   TIE·d·2^-23·(‖x‖² + max ‖c‖²) with TIE = 8, is d times that: 8× at
//   d = 8, where the f32 sums' roundings have the room the margin was
//   sized for; at d = 1 the split's worst case alone fills it, so a
//   label there stays within the rule only while the errors stay short of
//   their worst case (both rests near 2^-11 of their operands, of one
//   sign), as on every case of the tests.  One TF32 pass is off by up to
//   2^-11 relative and fails the rule on the examples' data.  The
//   split −2c and ‖c‖² stay in registers for the whole launch.  An exact
//   copy of an earlier centroid, and the padding past k, score +inf, so a
//   copy never takes a point whatever the tensor cores do with two equal
//   columns.
// * the argmin over each thread's columns, then over the quad by two
//   rounds of shuffles; the lowest index wins on equal scores.
// * sums as one_hot(labels)ᵀ·x on the tensor cores, as the TPU kernel did
//   them, and counts (onehot.cuh).  Points past n (the ragged tail) are zero
//   and take label −1.
//
// The finish adds every partial in a fixed place (onehot.cuh), so the same
// inputs give bit-identical sums and counts on every run, as the TPU
// kernel's grid in order did.  ref.kmeans_step_tiled is this arithmetic in
// plain torch.
//
// Counts are exact int32 (an f32 count is inexact past 2^24), written out
// as f32, as the JAX kernel returns them.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixsum.cuh"
#include "onehot.cuh"

#define KMS_TPB 256
#define KMS_MAX_D 128
#define KMS_BLOCKS_PER_SM 4
// what kms_launch returns when the centroid table passes the opt-in shared
// memory; below 0, so no CUDA error has this value
#define KMS_ERR_TABLE (-1)

// the tensor-core route's tickets: one for the grid, one per group of blocks
#define KMS_TICKETS OH_TICKETS

extern "C" {
// the largest point width the kernel takes, the code above and the tickets
// kms_launch wants (read by the wrapper)
int kms_max_d = KMS_MAX_D;
int kms_err_table = KMS_ERR_TABLE;
int kms_tickets = KMS_TICKETS;
}

// ---- kms_tc: the tensor-core route ------------------------------------------

static size_t ktc_smem_bytes(int kp, int dp) {
  return OH_STAGES * oh_rows_bytes(dp) + 2 * OH_STAGES * sizeof(uint64_t) +
         sizeof(float) * (kp * dp + 2 * kp);
}

// 16 points: the labels of rows 0 … 15 of xm (row stride ld), then their
// one-hot sums and counts into sacc and cacc.  PARTIAL: only the first
// `valid` rows are points.
template <int KP, int DP, bool EXACT, bool PARTIAL>
__device__ __forceinline__ void ktc_rows16(const float* xm, int ld, int d, int valid,
                                           const uint32_t (&bh)[KP / 8][DP / 8][2],
                                           const uint32_t (&bl)[KP / 8][DP / 8][2],
                                           const float (&c2r)[KP / 8][4],
                                           float (&sacc)[KP / 16][DP / 8][4],
                                           float (&cacc)[KP / 16][4], int lane) {
  constexpr int NT = KP / 8, KS = DP / 8;
  const int g = lane >> 2, t4 = lane & 3;
  // scores ‖c_j‖² + x·(−2c_j), the product split three ways and ‖c_j‖² the
  // first product's addend; the k index t of a fragment is dimension 2t and
  // t + 4 is 2t + 1, so a thread's two values are adjacent
  float acc[NT][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int dim = ks * 8 + 2 * t4;
    float v[4];
    if (EXACT) {
      const float2 r0 = *reinterpret_cast<const float2*>(xm + g * DP + dim);
      const float2 r1 = *reinterpret_cast<const float2*>(xm + (g + 8) * DP + dim);
      v[0] = r0.x, v[1] = r1.x, v[2] = r0.y, v[3] = r1.y;
    } else {
      v[0] = dim < d ? xm[g * ld + dim] : 0.f;
      v[1] = dim < d ? xm[(g + 8) * ld + dim] : 0.f;
      v[2] = dim + 1 < d ? xm[g * ld + dim + 1] : 0.f;
      v[3] = dim + 1 < d ? xm[(g + 8) * ld + dim + 1] : 0.f;
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = hop::tf32_rna(v[i]);
      al[i] = hop::tf32_rest(v[i], ah[i]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (ks == 0)
        hop::mma_tf32_m16n8k8(acc[nt], al, bh[nt][ks], c2r[nt]);
      else
        hop::mma_tf32_m16n8k8(acc[nt], al, bh[nt][ks]);
      hop::mma_tf32_m16n8k8(acc[nt], ah, bl[nt][ks]);
      hop::mma_tf32_m16n8k8(acc[nt], ah, bh[nt][ks]);
    }
  }
  // argmin of rows g (r = 0) and g + 8 (r = 1) over this thread's columns
  // 8·nt + 2·t4 + h, in increasing order
  float best[2];
  int at[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    best[r] = acc[0][2 * r];
    at[r] = 2 * t4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (nt == 0 && h == 0) continue;
        const float sc = acc[nt][2 * r + h];
        if (sc < best[r]) best[r] = sc, at[r] = nt * 8 + 2 * t4 + h;
      }
  }
  // then over the quad, lowest index on equal scores: lanes t4 = 0, 1 take
  // row g, lanes 2, 3 row g + 8, each from the lane two away, then the
  // pairs combine; the label of row r ends in lane 4·(r mod 8) + 2·(r ≥ 8)
  const bool upper = t4 >= 2;
  float mine = upper ? best[1] : best[0];
  int lab = upper ? at[1] : at[0];
#pragma unroll
  for (int o = 2; o >= 1; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, o == 2 ? (upper ? best[0] : best[1]) : mine, o);
    const int oa = __shfl_xor_sync(0xffffffffu, o == 2 ? (upper ? at[0] : at[1]) : lab, o);
    if (ob < mine || (ob == mine && oa < lab)) mine = ob, lab = oa;
  }
  if (PARTIAL && g + (upper ? 8 : 0) >= valid) lab = -1;
  // labels of points t4 and t4 + 4 of each 8-point k step: rows t4 and
  // t4 + 4 (k step 0), t4 + 8 and t4 + 12 (k step 1)
  const int labs[2][2] = {{__shfl_sync(0xffffffffu, lab, 4 * t4),
                           __shfl_sync(0xffffffffu, lab, 4 * t4 + 16)},
                          {__shfl_sync(0xffffffffu, lab, 4 * t4 + 2),
                           __shfl_sync(0xffffffffu, lab, 4 * t4 + 18)}};
  oh_rows16<KP, DP, EXACT, PARTIAL, true>(xm, ld, d, valid, labs, sacc, cacc, lane);
}

// Where kms_tc's results lie in a partial, and how they are written: the
// sums (k, d), then the counts (k,) as f32.
template <int KP, int DP>
struct KmsOut {
  float* sums;
  float* counts;
  int k, d;
  __device__ __forceinline__ int at(int e) const {
    return e >= k * d ? KP * DP + (e - k * d) : (e / d) * DP + e % d;
  }
  __device__ __forceinline__ void put(int e, unsigned v) const {
    if (e >= k * d) counts[e - k * d] = __int2float_rn(static_cast<int>(v));
    else sums[e] = __uint_as_float(v);
  }
};

// x (n, d), c (k, d); sums (k, d) and counts (k,) written by the last block;
// part: the partials of gridDim.x blocks and then of their groups, KP·DP +
// KP floats each; ticket: KMS_TICKETS zeros, before and after the launch.
// EXACT: d == DP and x 8-byte aligned (paired loads, no width guard):
// at the k-means path's shape it is 0.0370 ms a launch against 0.0494 for
// the general loads on the H100 (n = 2^21, d = 8, k = 16; PERF.md).
template <int KP, int DP, bool EXACT>
__global__ void __launch_bounds__(OH_THREADS, oh_blocks_per_sm(KP, DP))
kms_tc(const float* __restrict__ x, const float* __restrict__ c, long long n, int d, int k,
       float* __restrict__ sums, float* __restrict__ counts, float* __restrict__ part,
       unsigned* __restrict__ ticket) {
  constexpr int T = oh_tile_points(DP), PW = T / OH_WARPS;
  constexpr int NT = KP / 8, KS = DP / 8, MT = KP / 16, PART = oh_part(KP, DP, true);
  extern __shared__ __align__(128) unsigned char ring[];
  constexpr int STAGE = oh_rows_bytes(DP);
  static_assert(OH_STAGES * STAGE >= OH_WARPS * PART * 4, "the warps' partials fit in the ring");
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + OH_STAGES * STAGE);
  uint64_t* empty = full + OH_STAGES;
  float* cs = reinterpret_cast<float*>(empty + OH_STAGES);  // KP·DP centroids, zero padded
  float* c2s = cs + KP * DP;                                  // KP norms (+inf: set aside)
  int* copy = reinterpret_cast<int*>(c2s + KP);               // KP: 1 for a copy
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long tiles = (n + T - 1) / T;
  const int mine = blockIdx.x < tiles
                       ? static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x)
                       : 0;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int ld = EXACT ? DP : d;

  if (tid == 0) oh_ring_init(full, empty);
  __syncthreads();

  // each consumer warp's sums and counts over its slices of the block's tiles
  float run[MT][KS][4];
  int cnt[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    cnt[mt][0] = cnt[mt][1] = 0;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt)
      run[mt][dt][0] = run[mt][dt][1] = run[mt][dt][2] = run[mt][dt][3] = 0.f;
  }
  if (warp == OH_WARPS) {
    if (lane == 0) {  // the producer: the block's tiles of points in order
      const OhArray arr[1] = {{xa, d * static_cast<int>(sizeof(float))}};
      const int at[1] = {0};
      oh_produce(ring, STAGE, full, empty, mine, T, n, arr, at);
    }
  } else {  // the consumers, while the producer's first copies fly
    constexpr int CT = OH_WARPS * 32;
    for (int e = tid; e < KP * DP; e += CT) {
      const int j = e / DP, t = e % DP;
      cs[e] = j < k && t < d ? c[j * d + t] : 0.f;
    }
    for (int j = tid; j < KP; j += CT) copy[j] = 0;
    hop::bar_sync(1, CT);
    // copies of an earlier centroid, one pair (i < j) a thread at a time
    for (int p = tid; p < KP * KP; p += CT) {
      const int i = p / KP, j = p % KP;
      if (i < j && j < k) {
        bool same = true;
        for (int t = 0; t < d && same; ++t) same = cs[i * DP + t] == cs[j * DP + t];
        if (same) copy[j] = 1;
      }
    }
    hop::bar_sync(1, CT);
    for (int j = tid; j < KP; j += CT) {
      float s = 0.f;
      for (int t = 0; t < d; ++t) s = __fmaf_rn(cs[j * DP + t], cs[j * DP + t], s);
      c2s[j] = j < k && !copy[j] ? s : __int_as_float(0x7f800000);
    }
    hop::bar_sync(1, CT);
    const int g = lane >> 2, t4 = lane & 3;
    uint32_t bh[NT][KS][2], bl[NT][KS][2];
    float c2r[NT][4];  // the addend of a score fragment: ‖c‖² of its columns
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = __fmul_rn(-2.f, cs[(nt * 8 + g) * DP + ks * 8 + 2 * t4 + h]);
          bh[nt][ks][h] = hop::tf32_rna(v);
          bl[nt][ks][h] = hop::tf32_rna(__fsub_rn(v, __uint_as_float(bh[nt][ks][h])));
        }
      c2r[nt][0] = c2r[nt][2] = c2s[nt * 8 + 2 * t4];
      c2r[nt][1] = c2r[nt][3] = c2s[nt * 8 + 2 * t4 + 1];
    }
    const int off = static_cast<int>(xa & 15);
    for (int it = 0; it < mine; ++it) {
      const int s = it % OH_STAGES;
      hop::mbar_wait(&full[s], (it / OH_STAGES) & 1);
      const long long tile = blockIdx.x + static_cast<long long>(it) * gridDim.x;
      const long long left = n - tile * T - static_cast<long long>(warp) * PW;
      const int valid = left < PW ? static_cast<int>(left) : PW;
      const float* xs =
          reinterpret_cast<const float*>(ring + s * STAGE + off) + warp * PW * ld;
      // two sets of accumulators, for even and odd groups of 16 points, so
      // that two groups' products do not wait on each other
      float sacc[2][MT][KS][4], cacc[2][MT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          cacc[h][mt][0] = cacc[h][mt][1] = cacc[h][mt][2] = cacc[h][mt][3] = 0.f;
#pragma unroll
          for (int dt = 0; dt < KS; ++dt)
            sacc[h][mt][dt][0] = sacc[h][mt][dt][1] = sacc[h][mt][dt][2] = sacc[h][mt][dt][3] = 0.f;
        }
      if (valid >= PW) {
#pragma unroll
        for (int m = 0; m < PW / 16; ++m)
          ktc_rows16<KP, DP, EXACT, false>(xs + m * 16 * ld, ld, d, 16, bh, bl, c2r, sacc[m & 1],
                                           cacc[m & 1], lane);
      } else {
#pragma unroll
        for (int m = 0; m < PW / 16; ++m)
          if (m * 16 < valid)
            ktc_rows16<KP, DP, EXACT, true>(xs + m * 16 * ld, ld, d, valid - m * 16, bh, bl, c2r,
                                            sacc[m & 1], cacc[m & 1], lane);
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
      oh_tile_add<MT, KS, true>(run, cnt, sacc, cacc);
    }
  }
  oh_finish<KP, DP, true>(ring, run, cnt, part, ticket, k * d + k, KmsOut<KP, DP>{sums, counts, k, d});
}

template <int KP, int DP, bool EXACT>
static cudaError_t ktc_run(const float* x, const float* c, long long n, int d, int k,
                           float* sums, float* counts, float* part, unsigned* ticket, int grid,
                           cudaStream_t s) {
  const size_t bytes = ktc_smem_bytes(KP, DP);
  static uint64_t ready = 0;  // a bit per device whose limit is set
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (!(ready & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(kms_tc<KP, DP, EXACT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    ready |= bit;
  }
  kms_tc<KP, DP, EXACT><<<grid, OH_THREADS, bytes, s>>>(x, c, n, d, k, sums, counts, part,
                                                          ticket);
  return cudaGetLastError();
}

template <int KP, int DP>
static cudaError_t ktc_pick(bool exact, const float* x, const float* c, long long n, int d, int k,
                            float* sums, float* counts, float* part, unsigned* ticket, int grid,
                            cudaStream_t s) {
  return exact ? ktc_run<KP, DP, true>(x, c, n, d, k, sums, counts, part, ticket, grid, s)
               : ktc_run<KP, DP, false>(x, c, n, d, k, sums, counts, part, ticket, grid, s);
}

extern "C" {
// 1 where kms_launch takes the tensor-core kernel kms_tc for points of
// width d and k centroids, 0 where it takes kms_main
int kms_route(int d, int k) { return oh_in_range(d, k); }

// kms_tc's tiling, onehot.cuh's, which fixes the order of its sums and of
// segsum.cu's seg_tc (read by the wrapper, ref.kmeans_step_tiled and
// ref.segsum_tiled): points per tile at width d, the consumer warps that
// share a tile, the blocks whose partials one finisher adds
int kms_tc_warps = OH_WARPS;
int kms_tc_group = OH_GROUP;
int kms_tc_tile_points(int d) { return oh_tile_points(oh_dp(d)); }

// kms_tc's blocks for n points of width d and k centroids on a card of
// `sms` SMs: one per tile, at most oh_blocks_per_sm on each SM
int kms_tc_grid(long long n, int d, int k, int sms) { return oh_grid(n, d, k, sms); }

// the bytes of scratch kms_launch needs for n points of width d, k
// centroids and, on the kms_tc route, a grid of `grid` blocks (kms_main:
// its k·d sums' accumulators, k int32 counts and n int32 labels)
long long kms_scratch_bytes(long long n, int grid, int d, int k) {
  if (k < 1 || d < 1) return 0;
  if (!kms_route(d, k))
    return fix_seg_bytes(static_cast<long long>(k) * d) + static_cast<long long>(sizeof(int)) * (k + n);
  return oh_scratch_bytes(grid, oh_kp(k), oh_dp(d), true);
}
}

static cudaError_t ktc_launch(const float* x, const float* c, long long n, int d, int k,
                              float* sums, float* counts, float* part, unsigned* ticket,
                              int grid, cudaStream_t s) {
  const int kp = oh_kp(k), dp = oh_dp(d);
  const bool exact = d == dp && reinterpret_cast<uintptr_t>(x) % 8 == 0;
#define KTC_CASE(KP_, DP_)                                                                  \
  if (kp == KP_ && dp == DP_)                                                               \
    return ktc_pick<KP_, DP_>(exact, x, c, n, d, k, sums, counts, part, ticket, grid, s);
  KTC_CASE(16, 8)
  KTC_CASE(16, 16)
  KTC_CASE(16, 32)
  KTC_CASE(32, 8)
  KTC_CASE(32, 16)
  KTC_CASE(64, 8)
#undef KTC_CASE
  return cudaErrorInvalidValue;
}

// ---- kms_main: the CUDA-core route ------------------------------------------
//
// Two steps.  kms_main labels the points: one thread per point in a
// grid-stride loop; each block copies the centroids into shared memory and
// computes ‖c_j‖² once; a thread loads its point's d values into registers,
// forms ‖x‖² and each x·c_j as sums in index order, d² = (‖x‖² − 2·x·c_j) +
// ‖c_j‖² with the _rn intrinsics (the build runs --fmad=false), and keeps
// the first minimum (strict <, from j = 0), so duplicate centroids resolve
// to the lowest index as jnp.argmin does.  It writes the label to the
// scratch and counts it in int32 (in shared memory where k more words fit
// beside the centroids, flushed once per block; else in the global counts).
// Then the sums are fixsum.cuh's segment sums of the points by label
// (fix_seg_sum): integer adds at each (centroid, column)'s scale, the same
// bits on every run.

// DMAX: the point width rounded up to the next instantiated size, so that a
// point's values live in registers; SMEM: per-block shared counts.
template <int DMAX, bool SMEM>
__global__ void __launch_bounds__(KMS_TPB)
kms_main(const float* __restrict__ x, const float* __restrict__ c, long long n, int d, int k,
         int* __restrict__ labels, int* __restrict__ counts) {
  extern __shared__ float smem[];
  float* cs = smem;               // k·d centroids
  float* c2 = cs + k * d;         // k squared norms
  int* scnt = reinterpret_cast<int*>(c2 + k);  // k counts (SMEM only)
  for (int t = threadIdx.x; t < k * d; t += blockDim.x) cs[t] = c[t];
  if (SMEM)
    for (int j = threadIdx.x; j < k; j += blockDim.x) scnt[j] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < d; ++t) s = __fadd_rn(s, __fmul_rn(cs[j * d + t], cs[j * d + t]));
    c2[j] = s;
  }
  __syncthreads();
  int* tcnt = SMEM ? scnt : counts;
  const long long stride = static_cast<long long>(gridDim.x) * KMS_TPB;
  for (long long i = blockIdx.x * static_cast<long long>(KMS_TPB) + threadIdx.x; i < n;
       i += stride) {
    const float* xi = x + i * d;
    float xv[DMAX];
    float x2 = 0.f;
#pragma unroll
    for (int t = 0; t < DMAX; ++t) {
      xv[t] = t < d ? __ldg(xi + t) : 0.f;
      if (t < d) x2 = __fadd_rn(x2, __fmul_rn(xv[t], xv[t]));
    }
    int best = 0;
    float best_d2 = 0.f;
    for (int j = 0; j < k; ++j) {
      const float* cj = cs + j * d;
      float xc = 0.f;
#pragma unroll
      for (int t = 0; t < DMAX; ++t)
        if (t < d) xc = __fadd_rn(xc, __fmul_rn(xv[t], cj[t]));
      const float d2 = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, xc)), c2[j]);
      if (j == 0 || d2 < best_d2) {
        best = j;
        best_d2 = d2;
      }
    }
    labels[i] = best;
    atomicAdd(tcnt + best, 1);
  }
  if (SMEM) {
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += blockDim.x)
      if (scnt[j] != 0) atomicAdd(counts + j, scnt[j]);
  }
}

// counts (k,) f32 from the int32 counts kms_main added up
__global__ void kms_counts(const int* __restrict__ icounts, float* __restrict__ counts, int k) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < k; j += gridDim.x * blockDim.x)
    counts[j] = __int2float_rn(icounts[j]);
}

template <int DMAX, bool SMEM>
static cudaError_t kms_run(const float* x, const float* c, long long n, int d, int k,
                           int* labels, int* counts, size_t bytes, int grid, cudaStream_t s) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kms_main<DMAX, SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  kms_main<DMAX, SMEM><<<grid, KMS_TPB, bytes, s>>>(x, c, n, d, k, labels, counts);
  return cudaGetLastError();
}

template <int DMAX>
static cudaError_t kms_pick(bool smem, const float* x, const float* c, long long n, int d, int k,
                            int* labels, int* counts, size_t bytes, int grid, cudaStream_t s) {
  return smem ? kms_run<DMAX, true>(x, c, n, d, k, labels, counts, bytes, grid, s)
              : kms_run<DMAX, false>(x, c, n, d, k, labels, counts, bytes, grid, s);
}

// The labels and int32 counts into the scratch, then the sums: `scratch`
// holds kms_scratch_bytes (the sums' accumulators, the counts, the labels).
static cudaError_t kms_main_launch(const float* x, const float* c, long long n, int d, int k,
                                  float* sums, void* scratch, int** icounts, cudaStream_t s) {
  int dev = 0, optin = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t table = sizeof(float) * static_cast<size_t>(k) * (d + 1);
  if (table > static_cast<size_t>(optin)) return cudaError_t(KMS_ERR_TABLE);
  const bool smem = table + sizeof(int) * k <= static_cast<size_t>(optin);
  const size_t bytes = smem ? table + sizeof(int) * k : table;
  const long long cells = static_cast<long long>(k) * d;
  int* counts = reinterpret_cast<int*>(static_cast<char*>(scratch) + fix_seg_bytes(cells));
  int* labels = counts + k;
  *icounts = counts;
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(k), s);
  if (e != cudaSuccess) return e;
  if (n > 0) {
    const long long need = (n + KMS_TPB - 1) / KMS_TPB;
    const long long most = static_cast<long long>(sms) * KMS_BLOCKS_PER_SM;
    const int grid = static_cast<int>(need < most ? need : most);
    if (d <= 4) e = kms_pick<4>(smem, x, c, n, d, k, labels, counts, bytes, grid, s);
    else if (d <= 8) e = kms_pick<8>(smem, x, c, n, d, k, labels, counts, bytes, grid, s);
    else if (d <= 16) e = kms_pick<16>(smem, x, c, n, d, k, labels, counts, bytes, grid, s);
    else if (d <= 32) e = kms_pick<32>(smem, x, c, n, d, k, labels, counts, bytes, grid, s);
    else if (d <= 64) e = kms_pick<64>(smem, x, c, n, d, k, labels, counts, bytes, grid, s);
    else e = kms_pick<128>(smem, x, c, n, d, k, labels, counts, bytes, grid, s);
    if (e != cudaSuccess) return e;
  }
  const long long need = (n * d + KMS_TPB - 1) / KMS_TPB;
  const long long most = static_cast<long long>(sms) * KMS_BLOCKS_PER_SM;
  const int blocks = static_cast<int>(need < 1 ? 1 : (need < most ? need : most));
  return fix_seg_sum(x, labels, n, d, k, sums, scratch, blocks, s);
}

// x (n, d) and c (k, d) f32, row-major and contiguous; sums (k, d) f32 and
// counts (k,) f32 (exact int32 counts, converted) are written.  scratch
// holds kms_scratch_bytes(grid, d, k) bytes of anything.  On the kms_tc
// route (kms_route) the kernel runs `grid` blocks (kms_tc_grid for the
// card's SMs; 1 to 512) and ticket is KMS_TICKETS unsigned zeros that each
// launch leaves at 0 (one set per stream: launches that overlap must not
// share it, nor scratch); kms_main takes no ticket, labels and counts the
// points in the scratch (kms_scratch_bytes for n points), adds the sums
// there, and converts the counts in a last small kernel.  Returns
// KMS_ERR_TABLE when kms_main's centroids alone do not fit in the opt-in
// shared memory, cudaErrorInvalidValue for a shape neither route takes or
// a grid out of range, else the first CUDA error it meets (memsets,
// shared-memory attribute, launch).
extern "C" int kms_launch(const float* x, const float* c, long long n, int d, int k,
                          float* sums, float* counts, void* scratch, unsigned* ticket,
                          int grid, void* stream) {
  if (n < 0 || d < 1 || d > KMS_MAX_D || k < 1 || scratch == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kms_route(d, k)) {
    if (ticket == nullptr || grid < 1 || grid > OH_GROUP * OH_MAX_GROUPS)
      return cudaErrorInvalidValue;
    return ktc_launch(x, c, n, d, k, sums, counts, static_cast<float*>(scratch), ticket, grid,
                      s);
  }
  int* icounts = nullptr;
  const cudaError_t e = kms_main_launch(x, c, n, d, k, sums, scratch, &icounts, s);
  if (e != cudaSuccess) return e;
  kms_counts<<<(k + 255) / 256, 256, 0, s>>>(icounts, counts, k);
  return cudaGetLastError();
}
