// onehot.cuh: one_hot(labels)ᵀ·x on the tensor cores, the part that
// kmeans_step.cu's kms_tc (labels from the nearest centroid) and segsum.cu's
// seg_tc (labels from the segment ids) share: the tile ring, the one-hot
// product and the fixed-order finish.
//
// * The tile ring.  A persistent grid, each block of OH_WARPS consumer warps
//   and one producer warp; the rows are cut into tiles of 16 KB (512 points
//   at DP = 8), block b taking tiles b, b + G, b + 2G, … in that order.  The
//   producer's lane 0 keeps OH_STAGES tiles in flight, each one or more 1-D
//   bulk copies (cp.async.bulk, one per array of the tile: kms_tc's points,
//   seg_tc's rows and ids) into a stage of a ring of shared buffers on
//   mbarriers.  A bulk copy wants 16-byte aligned addresses and sizes, and a
//   chunk of a Split may start anywhere (a row of d = 3 is 12 bytes): each
//   copy takes the 16-byte granules that cover the tile, which never leave
//   the allocation's pages, and the consumers read the tile from the offset
//   address mod 16, the same for every tile (a tile's bytes are a multiple
//   of 16).  Each consumer warp takes 1/OH_WARPS of a tile, 16 points at a
//   time.
// * The one-hot product (oh_rows16): the one-hot of 16 labels (exact in
//   TF32) is A, the points B, split x = x_hi + x_lo (x_hi rounded as
//   cvt.rna does, x_lo the f32 rest, which an mma reads as TF32 toward zero,
//   so x_hi + x_lo is x within one f32 unit of x), mma.sync m16n8k8 in TF32
//   with f32 sums; counts through one more product with a B of ones.  A
//   label outside [0, KP) adds nothing, and points past n (the ragged tail)
//   are zero.  A tile's products start from zero and are added into the
//   warp's running sums in f32 (round to nearest, oh_tile_add), so the
//   tensor cores' own accumulation spans one tile only.  As on the TPU's
//   matrix unit, a point's value meets every label's row of the product: a
//   non-finite value reaches the other labels' sums of its 16 points too
//   (0·inf is NaN).
// * The finish (oh_finish) has no float atomics and no memsets.  Each block
//   adds its warps' sums in warp order and writes them, with its int32
//   counts, to a scratch buffer.  The blocks form groups of OH_GROUP; the
//   last block of a group to take its group's ticket adds the group's
//   partials in block order, and the last of those finishers to take the
//   grid's ticket adds the groups' in order.  A ticket is an
//   acquire-release atomic increment, so no fence of its own, that wraps
//   back to 0 for the next launch.  Each finisher issues all its loads
//   before its first add, so the finish costs two round trips to L2, not
//   one per block.  Every addition has a fixed place, so the same inputs
//   give bit-identical sums and counts on every run.
//
// Shapes: DP, the point width d rounded up to 8, 16 or 32; KP, the labels
// rounded up to 16, 32 or 64; KP·DP ≤ 512.  ref.kmeans_step_tiled and
// ref.segsum_tiled are this arithmetic in plain torch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

constexpr int OH_STAGES = 6;                       // tiles in flight
constexpr int OH_TILE_BYTES = 16384;               // a tile of rows (16 points a warp at least)
constexpr int OH_WARPS = 8;                        // consumer warps
constexpr int OH_THREADS = (OH_WARPS + 1) * 32;    // and one producer warp
constexpr uint32_t OH_ONE = 0x3f800000u;            // 1.0f, exact in TF32
constexpr int OH_GROUP = 32;       // blocks whose partials one group finisher adds
constexpr int OH_TICKETS = 17;     // one for the grid, one per group
constexpr int OH_MAX_GROUPS = OH_TICKETS - 1;  // so at most 512 blocks

__host__ __device__ constexpr int oh_dp(int d) { return d <= 8 ? 8 : d <= 16 ? 16 : 32; }
__host__ __device__ constexpr int oh_kp(int k) { return k <= 16 ? 16 : k <= 32 ? 32 : 64; }
__host__ __device__ constexpr int oh_tile_points(int dp) {  // at least 16 a warp
  const int fit = OH_TILE_BYTES / (4 * dp);
  return fit > 16 * OH_WARPS ? fit : 16 * OH_WARPS;
}
// a tile of rows of width dp and the 16-byte granules around it
__host__ __device__ constexpr int oh_rows_bytes(int dp) { return oh_tile_points(dp) * dp * 4 + 32; }
// two blocks an SM where kms_tc's registers fit (at most 113 a thread), else one
__host__ __device__ constexpr int oh_blocks_per_sm(int kp, int dp) { return kp * dp <= 256 ? 2 : 1; }

// 1 where d and k lie in the tensor-core kernels' range
__host__ __device__ constexpr bool oh_in_range(int d, int k) {
  return d >= 1 && d <= 32 && k >= 1 && k <= 64 && oh_kp(k) * oh_dp(d) <= 512;
}

// blocks for n points of width d and k labels on a card of `sms` SMs: one
// per tile, at most oh_blocks_per_sm on each SM, at most OH_GROUP·OH_MAX_GROUPS
static inline int oh_grid(long long n, int d, int k, int sms) {
  const long long tile = oh_tile_points(oh_dp(d));
  const long long tiles = (n + tile - 1) / tile;
  long long most = static_cast<long long>(sms) * oh_blocks_per_sm(oh_kp(k), oh_dp(d));
  most = most < OH_GROUP * OH_MAX_GROUPS ? most : OH_GROUP * OH_MAX_GROUPS;
  return static_cast<int>(tiles < 1 ? 1 : tiles < most ? tiles : most);
}

// the partial words of a block (and of a group): KP·DP sums, then with
// COUNTS KP int32 counts
__host__ __device__ constexpr int oh_part(int kp, int dp, bool counts) {
  return kp * dp + (counts ? kp : 0);
}

// the bytes of scratch a grid of `grid` blocks needs
static inline long long oh_scratch_bytes(int grid, int kp, int dp, bool counts) {
  if (grid < 1) return 0;
  return (grid + (grid + OH_GROUP - 1) / OH_GROUP) * static_cast<long long>(oh_part(kp, dp, counts)) *
         static_cast<long long>(sizeof(float));
}

// ---- the tile ring -----------------------------------------------------------

// One array that each tile copies a slice of: `base`, its first point, and
// `bytes` of it a point (the end lies at base + n·bytes).
struct OhArray {
  uintptr_t base;
  int bytes;
};

// The producer's lane 0: the block's `mine` tiles of T points in order,
// OH_STAGES in flight; tile `it` into stage it % OH_STAGES, array a at
// `at[a]` bytes into the stage (a multiple of 16), one bulk copy each.
template <int NA>
__device__ __forceinline__ void oh_produce(unsigned char* ring, int stage_bytes, uint64_t* full,
                                           uint64_t* empty, int mine, long long T, long long n,
                                           const OhArray (&arr)[NA], const int (&at)[NA]) {
  for (int it = 0; it < mine; ++it) {
    const int s = it % OH_STAGES;
    hop::mbar_wait(&empty[s], ((it / OH_STAGES) & 1) ^ 1);
    const long long first = (blockIdx.x + static_cast<long long>(it) * gridDim.x) * T;
    uintptr_t g0[NA];
    uint32_t bytes[NA], total = 0;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const uintptr_t end = arr[a].base + static_cast<uintptr_t>(n) * arr[a].bytes;
      const uintptr_t lo = arr[a].base + static_cast<uintptr_t>(first) * arr[a].bytes;
      const uintptr_t hi = lo + T * arr[a].bytes < end ? lo + T * arr[a].bytes : end;
      g0[a] = lo & ~uintptr_t(15);
      bytes[a] = static_cast<uint32_t>(((hi + 15) & ~uintptr_t(15)) - g0[a]);
      total += bytes[a];
    }
    hop::mbar_expect_tx(&full[s], total);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      hop::bulk_load(ring + s * stage_bytes + at[a], reinterpret_cast<const void*>(g0[a]), bytes[a],
                     &full[s]);
  }
}

// Thread 0 sets up the ring's barriers (before a __syncthreads).
__device__ __forceinline__ void oh_ring_init(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < OH_STAGES; ++s) {
    hop::mbar_init(&full[s], 1);
    hop::mbar_init(&empty[s], OH_WARPS);
  }
  hop::mbar_fence_init();
}

// ---- the one-hot product -------------------------------------------------------

// The one-hot sums of 16 points, rows 0 … 15 of xm (row stride ld), added
// into sacc and, with COUNTS, their counts into cacc: lab[q][0] and
// lab[q][1] are the labels of points 8q + t4 and 8q + t4 + 4 (t4 = lane mod
// 4).  PARTIAL: only the first `valid` rows are points.  EXACT: d == DP and
// no width guard.
template <int KP, int DP, bool EXACT, bool PARTIAL, bool COUNTS>
__device__ __forceinline__ void oh_rows16(const float* xm, int ld, int d, int valid,
                                          const int (&lab)[2][2], float (&sacc)[KP / 16][DP / 8][4],
                                          float (&cacc)[KP / 16][4], int lane) {
  constexpr int KS = DP / 8, MT = KP / 16;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t ones[2] = {OH_ONE, OH_ONE};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int l0 = lab[q][0], l1 = lab[q][1];
    const float* xq = xm + 8 * q * ld;
    const bool v0 = !PARTIAL || 8 * q + t4 < valid;
    const bool v1 = !PARTIAL || 8 * q + t4 + 4 < valid;
    uint32_t xh[KS][2], xl[KS][2];
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) {
      const int dim = dt * 8 + g;
      const bool in = EXACT || dim < d;
      const float u[2] = {in && v0 ? xq[t4 * ld + dim] : 0.f,
                          in && v1 ? xq[(t4 + 4) * ld + dim] : 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xh[dt][i] = hop::tf32_rna(u[i]);
        xl[dt][i] = hop::tf32_rest(u[i], xh[dt][i]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = mt * 16 + g;
      const uint32_t a[4] = {l0 == m0 ? OH_ONE : 0u, l0 == m0 + 8 ? OH_ONE : 0u,
                             l1 == m0 ? OH_ONE : 0u, l1 == m0 + 8 ? OH_ONE : 0u};
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        hop::mma_tf32_m16n8k8(sacc[mt][dt], a, xh[dt]);
        hop::mma_tf32_m16n8k8(sacc[mt][dt], a, xl[dt]);
      }
      if (COUNTS) hop::mma_tf32_m16n8k8(cacc[mt], a, ones);
    }
  }
}

// A tile's two sets of sums (for even and odd groups of 16 points, so that
// two groups' products do not wait on each other) added into the warp's
// running sums and counts, set 0 first, in f32 round to nearest.
template <int MT, int KS, bool COUNTS>
__device__ __forceinline__ void oh_tile_add(float (&run)[MT][KS][4], int (&cnt)[MT][2],
                                            const float (&sacc)[2][MT][KS][4],
                                            const float (&cacc)[2][MT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int dt = 0; dt < KS; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        run[mt][dt][i] = __fadd_rn(__fadd_rn(run[mt][dt][i], sacc[0][mt][dt][i]), sacc[1][mt][dt][i]);
    if (COUNTS) {
      cnt[mt][0] += __float2int_rn(cacc[0][mt][0]) + __float2int_rn(cacc[1][mt][0]);
      cnt[mt][1] += __float2int_rn(cacc[0][mt][2]) + __float2int_rn(cacc[1][mt][2]);
    }
  }
}

// ---- the finish ----------------------------------------------------------------

// the first `m` of v added in order: f32 sums (FLOAT, as bits) or int32 counts
template <bool FLOAT, int N>
__device__ __forceinline__ unsigned oh_add(const unsigned (&v)[N], int m) {
  if constexpr (FLOAT) {
    float s = __uint_as_float(v[0]);
#pragma unroll
    for (int i = 1; i < N; ++i)
      if (i < m) s = __fadd_rn(s, __uint_as_float(v[i]));
    return __float_as_uint(s);
  } else {
    int s = static_cast<int>(v[0]);
#pragma unroll
    for (int i = 1; i < N; ++i)
      if (i < m) s += static_cast<int>(v[i]);
    return static_cast<unsigned>(s);
  }
}

// After every tile is consumed (every thread of the block calls it): the
// consumer warps' running sums (and counts) through the ring's memory to
// the block's partial in part, then the group and grid finishers.  The
// last block writes each of the n_out results: out.at(e) is the result's
// word in a partial (a count where it is KP·DP or more), out.put(e, bits)
// writes it.  ticket: OH_TICKETS zeros, before and after the launch.
template <int KP, int DP, bool COUNTS, class Out>
__device__ __forceinline__ void oh_finish(unsigned char* ring, const float (&run)[KP / 16][DP / 8][4],
                                          const int (&cnt)[KP / 16][2], float* part, unsigned* ticket,
                                          int n_out, Out out) {
  constexpr int KS = DP / 8, MT = KP / 16, PART = oh_part(KP, DP, COUNTS);
  __shared__ unsigned last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __syncthreads();  // every tile consumed: the ring becomes the warps' partials
  if (warp < OH_WARPS) {
    const int g = lane >> 2, t4 = lane & 3;
    float* wp = reinterpret_cast<float*>(ring) + warp * KP * DP;
    int* wc = reinterpret_cast<int*>(ring) + OH_WARPS * KP * DP + warp * KP;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int j = mt * 16 + g;
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        const int t = dt * 8 + 2 * t4;
        wp[j * DP + t] = run[mt][dt][0];
        wp[j * DP + t + 1] = run[mt][dt][1];
        wp[(j + 8) * DP + t] = run[mt][dt][2];
        wp[(j + 8) * DP + t + 1] = run[mt][dt][3];
      }
      if (COUNTS && t4 == 0) wc[j] = cnt[mt][0], wc[j + 8] = cnt[mt][1];
    }
  }
  __syncthreads();
  // this block's partials, its warps added in order
  float* bp = part + static_cast<size_t>(blockIdx.x) * PART;
  const float* wp = reinterpret_cast<const float*>(ring);
  const int* wc = reinterpret_cast<const int*>(ring) + OH_WARPS * KP * DP;
  for (int e = tid; e < KP * DP; e += OH_THREADS) {
    float s = wp[e];
    for (int w = 1; w < OH_WARPS; ++w) s = __fadd_rn(s, wp[w * KP * DP + e]);
    bp[e] = s;
  }
  if (COUNTS)
    for (int j = tid; j < KP; j += OH_THREADS) {
      int s = 0;
      for (int w = 0; w < OH_WARPS; ++w) s += wc[w * KP + j];
      reinterpret_cast<int*>(bp + KP * DP)[j] = s;
    }
  // the last block of each group adds its group's partials in block order,
  // and the last of those finishers adds the groups' in order.  Each ticket
  // is an acquire-release increment by thread 0 after the block's barrier,
  // which orders the block's writes before it and the finisher's reads
  // after it (the increment wraps each ticket back to 0 as its group
  // completes)
  const int blocks = gridDim.x, groups = (blocks + OH_GROUP - 1) / OH_GROUP;
  const int grp = blockIdx.x / OH_GROUP;
  const int members = min(OH_GROUP, blocks - grp * OH_GROUP);
  __syncthreads();
  if (tid == 0)
    last = hop::atom_inc_acq_rel(&ticket[1 + grp], members - 1) == unsigned(members - 1);
  __syncthreads();
  if (!last) return;
  const unsigned* pu = reinterpret_cast<const unsigned*>(part);
  unsigned* gp = reinterpret_cast<unsigned*>(part) + static_cast<size_t>(blocks + grp) * PART;
  for (int e = tid; e < PART; e += OH_THREADS) {
    unsigned v[OH_GROUP];  // all the loads in flight before the first add
#pragma unroll
    for (int m = 0; m < OH_GROUP; ++m)
      v[m] = m < members ? __ldcg(pu + static_cast<size_t>(grp * OH_GROUP + m) * PART + e) : 0u;
    gp[e] = e < KP * DP ? oh_add<true>(v, members) : oh_add<false>(v, members);
  }
  __syncthreads();
  if (tid == 0) last = hop::atom_inc_acq_rel(&ticket[0], groups - 1) == unsigned(groups - 1);
  __syncthreads();
  if (!last) return;
  const unsigned* gu = pu + static_cast<size_t>(blocks) * PART;
  for (int e = tid; e < n_out; e += OH_THREADS) {
    const int at = out.at(e);
    unsigned v[OH_MAX_GROUPS];
#pragma unroll
    for (int m = 0; m < OH_MAX_GROUPS; ++m)
      v[m] = m < groups ? __ldcg(gu + static_cast<size_t>(m) * PART + at) : 0u;
    out.put(e, at < KP * DP ? oh_add<true>(v, groups) : oh_add<false>(v, groups));
  }
}
