// grouped.cuh: the accumulation of the grouped kernels generated per query
// (grouped_select_agg.cu, grouped_join_agg.cu), after the query's row
// functions (codegen.py, rowfn.cuh).  Each template walks its rows through a
// Rows policy:
//
//   template <class Visit> __device__ void walk(long long cap, Visit&& visit) const;
//
// which visits the rows as genrows.cuh's gen_walk does (a persistent grid,
// warps on tiles of consecutive rows, every lane of a warp together) and
// calls visit(r, ok) with ok set for the rows that are aggregated and r
// holding every column their values and bucket read.
//
// Three routes, fixed by the query's shape (GEN_NB buckets, GEN_NV values),
// never on failure:
//
// * reg, when NB·(1 + NV) accumulators fit in GRP_REG_BUDGET registers
//   (Q1: 6 buckets × 5; Q12: 7 × 3; Q4's join: 5 × 1): each thread keeps
//   every bucket's count and values in registers and adds a row into its
//   bucket by an unrolled compare against each bucket id (the TPU's one-hot,
//   held in registers); then the xor-shuffle and warp-order block reduction
//   and the fixed-order finish of relagg.cuh.  No atomics, one launch, the
//   same bits on every run for a given grid;
// * smem, when the accumulators fit in 48 KB of shared memory: each block
//   keeps a private copy and flushes the buckets it touched into the global
//   accumulators at the end;
// * global, for more buckets (Q4's inner count: 750,000): atomics on the
//   global accumulators.
//
// On the two atomic routes a warp first merges its lanes that add into the
// same bucket (__match_any_sync; the lowest lane of each group adds the
// group's count and values with one atomic each), since lineitem is
// generated clustered by order key and neighbouring rows often share a
// bucket.  Float sums are then added in an order that changes from run to
// run; float min/max use the sign-aware integer atomics of relagg.cuh; the
// global accumulators are filled with each aggregate's identity by a first
// launch.  Counts are int32 (an f32 count stops being exact at 2^24).
#pragma once

#include "genrows.cuh"
#include "relagg.cuh"

#define GRP_TPB 256
// accumulators (counts and values) a thread may hold on the reg route
#define GRP_REG_BUDGET 64
#define GRP_SMEM_BYTES (48 * 1024)

enum { GRP_REG = 0, GRP_SMEM = 1, GRP_GLOBAL = 2 };
constexpr long long GRP_ACCS = GEN_NB * (1 + GEN_NV);
constexpr int GRP_ROUTE = GRP_ACCS <= GRP_REG_BUDGET ? GRP_REG
                          : (GRP_ACCS * 4 <= GRP_SMEM_BYTES ? GRP_SMEM : GRP_GLOBAL);
// the reg route's buckets and partial words per block
constexpr int GRP_RNB = GRP_ROUTE == GRP_REG ? static_cast<int>(GEN_NB) : 1;
constexpr int GRP_E = GRP_RNB * (1 + GEN_NV);
constexpr int GRP_BLOCKS_PER_SM[3] = {2, 4, 8};

// ---- reg -------------------------------------------------------------------

struct GrpComb {
  __device__ __forceinline__ uint32_t operator()(int e, uint32_t a, uint32_t b) const {
    if (e < GRP_RNB) return a + b;
    return __float_as_uint(
        gen_comb((e - GRP_RNB) / GRP_RNB, __uint_as_float(a), __uint_as_float(b)));
  }
};

template <class Rows>
__global__ void __launch_bounds__(GRP_TPB, 2)
grp_reg(Rows rows, long long cap, uint32_t* __restrict__ part, unsigned* ticket,
        int* __restrict__ out_cnt, float* __restrict__ out_acc) {
  int cnt[GRP_RNB];
  float acc[GRP_RNB][GEN_NV1];
#pragma unroll
  for (int b = 0; b < GRP_RNB; ++b) {
    cnt[b] = 0;
#pragma unroll
    for (int k = 0; k < GEN_NV1; ++k) acc[b][k] = gen_ident(k);
  }
  // each row into its bucket by an unrolled compare against every bucket id
  rows.walk(cap, [&](GenRow (&r)[GEN_ROWS], uint32_t (&ok)[GEN_ROWS]) {
#pragma unroll
    for (int u = 0; u < GEN_ROWS; ++u) {
      if (!ok[u]) continue;
      float v[GEN_NV1];
      gen_values(r[u], v);
      const long long bucket = gen_bucket(r[u]);
#pragma unroll
      for (int b = 0; b < GRP_RNB; ++b) {
        const bool hit = bucket == b;
        cnt[b] += hit;
#pragma unroll
        for (int k = 0; k < GEN_NV; ++k) acc[b][k] = hit ? gen_comb(k, acc[b][k], v[k]) : acc[b][k];
      }
    }
  });

  // words: the counts of buckets 0..NB-1, then value k of bucket b at NB·(1 + k) + b
  uint32_t w[GRP_E];
#pragma unroll
  for (int b = 0; b < GRP_RNB; ++b) {
    w[b] = static_cast<uint32_t>(cnt[b]);
#pragma unroll
    for (int k = 0; k < GEN_NV; ++k) w[GRP_RNB * (1 + k) + b] = __float_as_uint(acc[b][k]);
  }
  rel_block_partials<GRP_E, GRP_TPB>(w, part, GrpComb());
  if (!rel_last_block(ticket)) return;
  rel_finish<GRP_E, GRP_TPB>(part, GrpComb(), [&](int e, uint32_t v) {
    if (e < GRP_RNB) out_cnt[e] = static_cast<int>(v);
    else out_acc[e - GRP_RNB] = __uint_as_float(v);
  });
}

// ---- smem and global ---------------------------------------------------------

// Adds one row per lane (bucket < 0: none) into cnt/acc, after merging the
// lanes of the warp that add into the same bucket: each lane sums its
// group's values in lane order, and the group's lowest lane adds them.
// Every lane of the warp calls it.
__device__ __forceinline__ void grp_merge_add(long long bucket, float (&v)[GEN_NV1], int* cnt,
                                              float* acc, long long nb) {
  const int lane = threadIdx.x & 31;
  const unsigned grp = __match_any_sync(0xffffffffu, bucket);
  if (GEN_NV > 0) {
    const int more = __reduce_max_sync(0xffffffffu, bucket >= 0 ? __popc(grp) - 1 : 0);
    float own[GEN_NV1];  // the lanes' own values: what the shuffles read
#pragma unroll
    for (int k = 0; k < GEN_NV1; ++k) own[k] = v[k];
    unsigned rest = grp & ~(1u << lane);
    for (int it = 0; it < more; ++it) {
      const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) {
        const float o = __shfl_sync(0xffffffffu, own[k], src);
        if (rest) v[k] = gen_comb(k, v[k], o);
      }
      rest &= rest - 1;
    }
  }
  if (bucket < 0 || lane != __ffs(grp) - 1) return;
  atomicAdd(cnt + bucket, __popc(grp));
#pragma unroll
  for (int k = 0; k < GEN_NV; ++k) rel_atomic(gen_fn(k), acc + k * nb + bucket, v[k]);
}

template <class Rows, bool SMEM>
__global__ void __launch_bounds__(GRP_TPB)
grp_atomic(Rows rows, long long cap, int* __restrict__ cnt, float* __restrict__ acc) {
  extern __shared__ uint32_t smem[];
  int* tcnt = cnt;
  float* tacc = acc;
  if (SMEM) {
    tcnt = reinterpret_cast<int*>(smem);
    tacc = reinterpret_cast<float*>(smem + GEN_NB);
    for (long long b = threadIdx.x; b < GEN_NB; b += GRP_TPB) {
      tcnt[b] = 0;
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) tacc[k * GEN_NB + b] = gen_ident(k);
    }
    __syncthreads();
  }
  rows.walk(cap, [&](GenRow (&r)[GEN_ROWS], uint32_t (&ok)[GEN_ROWS]) {
#pragma unroll
    for (int u = 0; u < GEN_ROWS; ++u) {
      float v[GEN_NV1];
#pragma unroll
      for (int k = 0; k < GEN_NV1; ++k) v[k] = gen_ident(k);
      long long bucket = -1;
      if (ok[u]) {
        gen_values(r[u], v);
        bucket = gen_bucket(r[u]);
      }
      grp_merge_add(bucket, v, tcnt, tacc, GEN_NB);
    }
  });
  if (SMEM) {
    __syncthreads();
    for (long long b = threadIdx.x; b < GEN_NB; b += GRP_TPB) {
      const int n = tcnt[b];
      if (n == 0) continue;
      atomicAdd(cnt + b, n);
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) rel_atomic(gen_fn(k), acc + k * GEN_NB + b, tacc[k * GEN_NB + b]);
    }
  }
}

// Fills the global accumulators: counts 0, each value its identity.
__global__ void grp_init(int* __restrict__ cnt, float* __restrict__ acc) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; b < GEN_NB;
       b += stride) {
    cnt[b] = 0;
#pragma unroll
    for (int k = 0; k < GEN_NV; ++k) acc[k * GEN_NB + b] = gen_ident(k);
  }
}

static inline int grp_grid(long long cap) {
  return rel_grid(cap, GEN_BLOCK_ROWS(GRP_TPB), GRP_BLOCKS_PER_SM[GRP_ROUTE]);
}

// Bytes of scratch a pass over `cap` rows needs (reg: one partial per
// block; the atomic routes none).
static inline long long grp_scratch_bytes(long long cap) {
  return GRP_ROUTE == GRP_REG ? static_cast<long long>(grp_grid(cap)) * GRP_E * 4 : 0;
}

// Counts into cnt[0..NB) and value k of bucket b into acc[k·NB + b] over the
// rows of [0, cap) that `rows` visits.  reg: one launch, `ticket` a zeroed
// word that each launch leaves zeroed, `scratch` at least
// grp_scratch_bytes(cap); smem and global: the accumulators' fill, then the
// pass.
template <class Rows>
static cudaError_t grp_launch(const Rows& rows, long long cap, void* scratch, unsigned* ticket,
                              int* cnt, float* acc, cudaStream_t s) {
  // only the route's kernel is instantiated (if constexpr), so nvcc builds one
  const int grid = grp_grid(cap);
  if constexpr (GRP_ROUTE == GRP_REG) {
    grp_reg<Rows><<<grid, GRP_TPB, 0, s>>>(rows, cap, static_cast<uint32_t*>(scratch), ticket,
                                           cnt, acc);
    return cudaGetLastError();
  } else {
    const long long init = (GEN_NB + GRP_TPB - 1) / GRP_TPB;
    grp_init<<<static_cast<int>(init < 4096 ? init : 4096), GRP_TPB, 0, s>>>(cnt, acc);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if constexpr (GRP_ROUTE == GRP_SMEM)
      grp_atomic<Rows, true><<<grid, GRP_TPB, static_cast<size_t>(GRP_ACCS * 4), s>>>(rows, cap,
                                                                                     cnt, acc);
    else
      grp_atomic<Rows, false><<<grid, GRP_TPB, 0, s>>>(rows, cap, cnt, acc);
    return cudaGetLastError();
  }
}
