// segsum: the rows of data (n, d) f32 summed by segment id (n,) int32 into
// (K, d) f32; ids outside [0, K) are dropped.
//
// Replaces src/repro/kernels/segsum.py:segsum_p.  The TPU has no cheap
// scatter, so that kernel built a (rows, K) one-hot per row block and ran
// one_hotᵀ·data on the matrix unit; its wrapper padded the rows to the block
// size and sent the padding to an extra dump segment.  Here the grid stops
// at n, so there is no padding; the dump segment's rule stays: only ids in
// range count.
//
// Bound on the card: memory.  data and the ids are read once, n·(d+1)·4
// bytes (the k-means SegSum, n = 2^24 and d = 8: 604 MB, 180 us at 3.35
// TB/s), and K·d sums are written.
//
// Two routes, chosen by shape in seg_launch (seg_route), never on failure:
//
// * seg_tc, on the tensor cores, for d ≤ 32 and K ≤ 64 with KP·DP ≤ 512
//   (kmeans_step.cu's kms_tc range; KP is K rounded up to 16, 32 or 64, DP
//   is d rounded up to 8, 16 or 32).  The TPU kernel's product, built from
//   onehot.cuh as kms_tc's sums are: a persistent grid of bulk-copied tiles
//   (16 KB of rows and, as a second bulk copy of the same stage, their
//   ids, each by the 16-byte granules that cover it, so views that start
//   mid-granule need no copy), one_hot(ids)ᵀ·data by mma.sync in TF32 with
//   the rows split hi + lo, and the fixed-order finish: no atomics, the
//   same bits on every run.  An id outside [0, K) matches no row of the
//   one-hot that is written out, so it is dropped, and so is a row past n.
//   As on the TPU, a non-finite value reaches the other segments' sums of
//   its column within its 16 rows (0·inf is NaN): finite data only.
//   ref.segsum_tiled is this arithmetic in plain torch.
// * seg_main, on the CUDA cores, for every other shape: fixsum.cuh's
//   segment sums (fix_seg_sum), one thread per element of data, (row,
//   column), in a grid-stride loop over n·d, so neighbouring threads read
//   neighbouring addresses; the d threads of a row share its id through
//   the cache.  Two passes over the data: each (segment, column)'s largest
//   exponent, then each element added as an int64 at that scale, per block
//   in shared memory (up to the opt-in limit, 227 KB on sm_90) and merged
//   into the global accumulators at the block's end; then the f32 of each.
//   Integer adds do not depend on their order, so the sums are the same
//   bits on every run.
//   Contention of the atomics on K·d addresses sets its pace: on the
//   k-means SegSum the f32 atomics ran at 5.4 times the bound (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "fixsum.cuh"
#include "onehot.cuh"

#define SEG_TPB 256
#define SEG_BLOCKS_PER_SM 4

extern "C" {
// the tickets seg_launch wants on the seg_tc route (read by the wrapper);
// seg_tc's tiling is onehot.cuh's, which kmeans_step.cu exports
int seg_tickets = OH_TICKETS;
}

// ---- seg_tc: the tensor-core route ------------------------------------------

// a stage of the ring: a tile of rows of width dp, then the tile's ids, each
// with the 16-byte granules around it
__host__ __device__ constexpr int stc_stage_bytes(int dp) {
  return oh_rows_bytes(dp) + oh_tile_points(dp) * 4 + 32;
}
static size_t stc_smem_bytes(int dp) {
  return OH_STAGES * stc_stage_bytes(dp) + 2 * OH_STAGES * sizeof(uint64_t);
}

// the labels of points 8q + t4 and 8q + t4 + 4 of 16 rows whose ids start
// at `is` (PARTIAL: −1 past the first `valid`)
template <bool PARTIAL>
__device__ __forceinline__ void stc_labels(const int* is, int valid, int t4, int (&lab)[2][2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * q + t4 + 4 * h;
      lab[q][h] = !PARTIAL || r < valid ? is[r] : -1;
    }
}

// Where seg_tc's sums lie in a partial, and how they are written.
template <int KP, int DP>
struct SegOut {
  float* out;
  int d;
  __device__ __forceinline__ int at(int e) const { return (e / d) * DP + e % d; }
  __device__ __forceinline__ void put(int e, unsigned v) const { out[e] = __uint_as_float(v); }
};

// data (n, d), ids (n,); out (K, d) written by the last block; part: the
// partials of gridDim.x blocks and then of their groups, KP·DP floats each;
// ticket: OH_TICKETS zeros, before and after the launch.  EXACT: d == DP
// (no width guard).
template <int KP, int DP, bool EXACT>
__global__ void __launch_bounds__(OH_THREADS, oh_blocks_per_sm(KP, DP))
seg_tc(const float* __restrict__ data, const int* __restrict__ ids, long long n, int d, int K,
       float* __restrict__ out, float* __restrict__ part, unsigned* __restrict__ ticket) {
  constexpr int T = oh_tile_points(DP), PW = T / OH_WARPS;
  constexpr int KS = DP / 8, MT = KP / 16, PART = oh_part(KP, DP, false);
  constexpr int ROWS = oh_rows_bytes(DP), STAGE = stc_stage_bytes(DP);
  extern __shared__ __align__(128) unsigned char ring[];
  static_assert(OH_STAGES * STAGE >= OH_WARPS * PART * 4, "the warps' partials fit in the ring");
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + OH_STAGES * STAGE);
  uint64_t* empty = full + OH_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long tiles = (n + T - 1) / T;
  const int mine = blockIdx.x < tiles
                       ? static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x)
                       : 0;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(data), ia = reinterpret_cast<uintptr_t>(ids);
  const int ld = EXACT ? DP : d;

  if (tid == 0) oh_ring_init(full, empty);
  __syncthreads();

  // each consumer warp's sums over its slices of the block's tiles (no counts)
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
    if (lane == 0) {  // the producer: the block's tiles of rows and ids in order
      const OhArray arr[2] = {{xa, d * static_cast<int>(sizeof(float))},
                              {ia, static_cast<int>(sizeof(int))}};
      const int at[2] = {0, ROWS};
      oh_produce(ring, STAGE, full, empty, mine, T, n, arr, at);
    }
  } else {  // the consumers
    const int t4 = lane & 3;
    const int xoff = static_cast<int>(xa & 15), ioff = static_cast<int>(ia & 15);
    for (int it = 0; it < mine; ++it) {
      const int s = it % OH_STAGES;
      hop::mbar_wait(&full[s], (it / OH_STAGES) & 1);
      const long long tile = blockIdx.x + static_cast<long long>(it) * gridDim.x;
      const long long left = n - tile * T - static_cast<long long>(warp) * PW;
      const int valid = left < PW ? static_cast<int>(left) : PW;
      const float* xs = reinterpret_cast<const float*>(ring + s * STAGE + xoff) + warp * PW * ld;
      const int* is = reinterpret_cast<const int*>(ring + s * STAGE + ROWS + ioff) + warp * PW;
      // two sets of accumulators, for even and odd groups of 16 rows
      float sacc[2][MT][KS][4], cacc[2][MT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int dt = 0; dt < KS; ++dt)
            sacc[h][mt][dt][0] = sacc[h][mt][dt][1] = sacc[h][mt][dt][2] = sacc[h][mt][dt][3] = 0.f;
      int lab[2][2];
      if (valid >= PW) {
#pragma unroll
        for (int m = 0; m < PW / 16; ++m) {
          stc_labels<false>(is + m * 16, 16, t4, lab);
          oh_rows16<KP, DP, EXACT, false, false>(xs + m * 16 * ld, ld, d, 16, lab, sacc[m & 1],
                                                 cacc[m & 1], lane);
        }
      } else {
#pragma unroll
        for (int m = 0; m < PW / 16; ++m)
          if (m * 16 < valid) {
            stc_labels<true>(is + m * 16, valid - m * 16, t4, lab);
            oh_rows16<KP, DP, EXACT, true, false>(xs + m * 16 * ld, ld, d, valid - m * 16, lab,
                                                  sacc[m & 1], cacc[m & 1], lane);
          }
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
      oh_tile_add<MT, KS, false>(run, cnt, sacc, cacc);
    }
  }
  oh_finish<KP, DP, false>(ring, run, cnt, part, ticket, K * d, SegOut<KP, DP>{out, d});
}

template <int KP, int DP, bool EXACT>
static cudaError_t stc_run(const float* data, const int* ids, long long n, int d, int K,
                           float* out, float* part, unsigned* ticket, int grid, cudaStream_t s) {
  const size_t bytes = stc_smem_bytes(DP);
  static uint64_t ready = 0;  // a bit per device whose limit is set
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (!(ready & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(seg_tc<KP, DP, EXACT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    ready |= bit;
  }
  seg_tc<KP, DP, EXACT><<<grid, OH_THREADS, bytes, s>>>(data, ids, n, d, K, out, part, ticket);
  return cudaGetLastError();
}

static cudaError_t stc_launch(const float* data, const int* ids, long long n, int d, int K,
                              float* out, float* part, unsigned* ticket, int grid,
                              cudaStream_t s) {
  const int kp = oh_kp(K), dp = oh_dp(d);
  const bool exact = d == dp;
#define STC_CASE(KP_, DP_)                                                                    \
  if (kp == KP_ && dp == DP_)                                                                 \
    return exact ? stc_run<KP_, DP_, true>(data, ids, n, d, K, out, part, ticket, grid, s)    \
                 : stc_run<KP_, DP_, false>(data, ids, n, d, K, out, part, ticket, grid, s);
  STC_CASE(16, 8)
  STC_CASE(16, 16)
  STC_CASE(16, 32)
  STC_CASE(32, 8)
  STC_CASE(32, 16)
  STC_CASE(64, 8)
#undef STC_CASE
  return cudaErrorInvalidValue;
}

extern "C" {
// 1 where seg_launch takes the tensor-core kernel seg_tc for rows of width
// d and K segments, 0 where it takes seg_main
int seg_route(int d, int k) { return oh_in_range(d, k); }

// the bytes of scratch seg_launch needs for width d, K segments and, on the
// seg_tc route, a grid of `grid` blocks (seg_main: its K·d accumulators)
long long seg_scratch_bytes(int grid, int d, int k) {
  if (k < 1 || d < 1) return 0;
  if (!seg_route(d, k)) return fix_seg_bytes(static_cast<long long>(k) * d);
  return oh_scratch_bytes(grid, oh_kp(k), oh_dp(d), false);
}
}

// data (n, d) f32 and ids (n,) int32, contiguous; out (K, d) f32 is
// written.  scratch holds seg_scratch_bytes(grid, d, K) bytes of anything.
// On the seg_tc route (seg_route) the kernel runs `grid` blocks
// (kmeans_step.cu's kms_tc_grid for the card's SMs; 1 to 512) and ticket is
// seg_tickets unsigned zeros that each launch leaves at 0 (one set per
// stream: launches that overlap must not share it, nor scratch); seg_main
// takes no ticket and zeroes its scratch first.  Returns
// cudaErrorInvalidValue for a grid out of range, else the first CUDA error
// it meets.
extern "C" int seg_launch(const float* data, const int* ids, long long n, int d, int K,
                          float* out, void* scratch, unsigned* ticket, int grid, void* stream) {
  if (n < 0 || d < 1 || K < 1 || scratch == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seg_route(d, K)) {
    if (ticket == nullptr || grid < 1 || grid > OH_GROUP * OH_MAX_GROUPS)
      return cudaErrorInvalidValue;
    return stc_launch(data, ids, n, d, K, out, static_cast<float*>(scratch), ticket, grid, s);
  }
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (n * d + SEG_TPB - 1) / SEG_TPB;
  const long long most = static_cast<long long>(sms) * SEG_BLOCKS_PER_SM;
  const int blocks = static_cast<int>(need < 1 ? 1 : (need < most ? need : most));
  return fix_seg_sum(data, ids, n, d, K, out, scratch, blocks, s);
}
