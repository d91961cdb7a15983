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
// * smem, when the accumulators fit in 48 KB of shared memory as 32-bit
//   words: each block keeps a private copy (the sums as int64 beside them,
//   up to 144 KB) and flushes the buckets it touched into the global
//   accumulators at the end;
// * global, for more buckets (Q4's inner count: 750,000; the stream's
//   revenue state): atomics on the global accumulators.
//
// On the two atomic routes a warp first merges its lanes that add into the
// same bucket (__match_any_sync; the lowest lane of each group adds the
// group's count and values with one atomic each), since lineitem is
// generated clustered by order key and neighbouring rows often share a
// bucket.  Float sums there are fixsum.cuh's: a first pass over the rows
// notes each bucket's largest exponent (grp_scale), the second adds each
// value as an int64 at that scale (grp_atomic), and a last launch writes
// the f32 (grp_fix), so the bits do not depend on the order of the
// atomics.  Float min/max use the sign-aware integer atomics of relagg.cuh
// (their result has no order either); the global accumulators are filled
// with each aggregate's identity by a first launch.  Counts are int32 (an
// f32 count stops being exact at 2^24).
#pragma once

#include "fixsum.cuh"
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
//
// Scratch of the atomic routes: the int64 sums fx[k·NB + b] of the sum
// values, then their scale words sw[k·NB + b] (fixsum.cuh), for every value
// k (a min or max leaves its pair unused).

// whether the query has a sum among its values (host and device)
__host__ __device__ __forceinline__ bool grp_has_sum() {
  for (int k = 0; k < GEN_NV; ++k)
    if (gen_fn(k) == 0) return true;
  return false;
}

constexpr long long GRP_FIX_CELLS = GEN_NB * GEN_NV;
// the smem route's block-private accumulators: int64 sums, counts, min/max
constexpr long long GRP_SMEM_FIX = GRP_FIX_CELLS * 8 + GEN_NB * 4 + GRP_FIX_CELLS * 4;

// The lanes of the warp whose row goes to the same bucket (bucket < 0:
// none): the group's mask, and in its lowest lane (the one that adds) the
// group's values combined in lane order, each sum's integers added.
// Every lane of the warp calls it.
__device__ __forceinline__ unsigned grp_merge(long long bucket, float (&v)[GEN_NV1],
                                              long long (&q)[GEN_NV1]) {
  const int lane = threadIdx.x & 31;
  const unsigned grp = __match_any_sync(0xffffffffu, bucket);
  if (GEN_NV > 0) {
    const int more = __reduce_max_sync(0xffffffffu, bucket >= 0 ? __popc(grp) - 1 : 0);
    float own[GEN_NV1];  // the lanes' own values: what the shuffles read
    long long qown[GEN_NV1];
#pragma unroll
    for (int k = 0; k < GEN_NV1; ++k) {
      own[k] = v[k];
      qown[k] = q[k];
    }
    unsigned rest = grp & ~(1u << lane);
    for (int it = 0; it < more; ++it) {
      const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) {
        if (gen_fn(k) == 0) {
          const long long o = __shfl_sync(0xffffffffu, qown[k], src);
          if (rest) q[k] += o;
        } else {
          const float o = __shfl_sync(0xffffffffu, own[k], src);
          if (rest) v[k] = gen_comb(k, v[k], o);
        }
      }
      rest &= rest - 1;
    }
  }
  return grp;
}

// The first pass where the query sums: each sum value's exponent into its
// bucket's scale word (SMEM: a block-private copy merged at the end).
template <class Rows, bool SMEM>
__global__ void __launch_bounds__(GRP_TPB)
grp_scale(Rows rows, long long cap, uint32_t* __restrict__ sw) {
  extern __shared__ uint32_t smem[];
  uint32_t* w = SMEM ? smem : sw;
  if (SMEM) {
    for (long long t = threadIdx.x; t < GRP_FIX_CELLS; t += GRP_TPB) w[t] = 0;
    __syncthreads();
  }
  rows.walk(cap, [&](GenRow (&r)[GEN_ROWS], uint32_t (&ok)[GEN_ROWS]) {
#pragma unroll
    for (int u = 0; u < GEN_ROWS; ++u) {
      if (!ok[u]) continue;
      float v[GEN_NV1];
      gen_values(r[u], v);
      const long long bucket = gen_bucket(r[u]);
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k)
        if (gen_fn(k) == 0) fix_merge(w + k * GEN_NB + bucket, fix_word(v[k]));
    }
  });
  if (SMEM) {
    __syncthreads();
    for (long long t = threadIdx.x; t < GRP_FIX_CELLS; t += GRP_TPB) fix_merge(sw + t, w[t]);
  }
}

// The accumulation: counts, min/max, and each sum as fixsum.cuh's integers
// at the scale the first pass noted.
template <class Rows, bool SMEM>
__global__ void __launch_bounds__(GRP_TPB)
grp_atomic(Rows rows, long long cap, int* __restrict__ cnt, float* __restrict__ acc,
           long long* __restrict__ fx, const uint32_t* __restrict__ sw) {
  extern __shared__ uint32_t smem[];
  int* tcnt = cnt;
  float* tacc = acc;
  long long* tfx = fx;
  if (SMEM) {
    tfx = reinterpret_cast<long long*>(smem);
    tcnt = reinterpret_cast<int*>(tfx + GRP_FIX_CELLS);
    tacc = reinterpret_cast<float*>(tcnt + GEN_NB);
    for (long long b = threadIdx.x; b < GEN_NB; b += GRP_TPB) {
      tcnt[b] = 0;
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) {
        tacc[k * GEN_NB + b] = gen_ident(k);
        tfx[k * GEN_NB + b] = 0;
      }
    }
    __syncthreads();
  }
  const int frac = fix_frac(cap);
  const int lane = threadIdx.x & 31;
  rows.walk(cap, [&](GenRow (&r)[GEN_ROWS], uint32_t (&ok)[GEN_ROWS]) {
#pragma unroll
    for (int u = 0; u < GEN_ROWS; ++u) {
      float v[GEN_NV1];
      long long q[GEN_NV1];
#pragma unroll
      for (int k = 0; k < GEN_NV1; ++k) {
        v[k] = gen_ident(k);
        q[k] = 0;
      }
      long long bucket = -1;
      if (ok[u]) {
        gen_values(r[u], v);
        bucket = gen_bucket(r[u]);
#pragma unroll
        for (int k = 0; k < GEN_NV; ++k)
          if (gen_fn(k) == 0) q[k] = fix_int(v[k], __ldg(sw + k * GEN_NB + bucket), frac);
      }
      const unsigned grp = grp_merge(bucket, v, q);
      if (bucket < 0 || lane != __ffs(grp) - 1) continue;
      atomicAdd(tcnt + bucket, __popc(grp));
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) {
        if (gen_fn(k) == 0) fix_add(tfx + k * GEN_NB + bucket, q[k]);
        else rel_atomic(gen_fn(k), tacc + k * GEN_NB + bucket, v[k]);
      }
    }
  });
  if (SMEM) {
    __syncthreads();
    for (long long b = threadIdx.x; b < GEN_NB; b += GRP_TPB) {
      const int n = tcnt[b];
      if (n == 0) continue;
      atomicAdd(cnt + b, n);
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) {
        if (gen_fn(k) == 0) fix_add(fx + k * GEN_NB + b, tfx[k * GEN_NB + b]);
        else rel_atomic(gen_fn(k), acc + k * GEN_NB + b, tacc[k * GEN_NB + b]);
      }
    }
  }
}

// Fills the global accumulators: counts 0, each value its identity, the
// sums' integers and scale words 0.  (This and grp_fix are templates so
// that only the atomic routes' libraries compile them.)
template <class Rows>
__global__ void grp_init(int* __restrict__ cnt, float* __restrict__ acc, long long* __restrict__ fx,
                         uint32_t* __restrict__ sw) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; b < GEN_NB;
       b += stride) {
    cnt[b] = 0;
#pragma unroll
    for (int k = 0; k < GEN_NV; ++k) {
      acc[k * GEN_NB + b] = gen_ident(k);
      fx[k * GEN_NB + b] = 0;
      sw[k * GEN_NB + b] = 0;
    }
  }
}

// Writes each sum value's f32 from its integers and scale word.
template <class Rows>
__global__ void grp_fix(float* __restrict__ acc, const long long* __restrict__ fx,
                        const uint32_t* __restrict__ sw, long long cap) {
  const int frac = fix_frac(cap);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       t < GRP_FIX_CELLS; t += stride)
    if (gen_fn(static_cast<int>(t / GEN_NB)) == 0) acc[t] = fix_float(fx[t], sw[t], frac);
}

// blocks of the smem route an SM holds at once (228 KB a SM, 1 KB of it
// reserved per block), at most the route's blocks per SM
constexpr int GRP_SMEM_PER_SM = 232448 / (GRP_SMEM_FIX + 1024) < 1 ? 1
                                : (232448 / (GRP_SMEM_FIX + 1024) > GRP_BLOCKS_PER_SM[GRP_SMEM]
                                       ? GRP_BLOCKS_PER_SM[GRP_SMEM]
                                       : static_cast<int>(232448 / (GRP_SMEM_FIX + 1024)));

static inline int grp_grid(long long cap) {
  return rel_grid(cap, GEN_BLOCK_ROWS(GRP_TPB),
                  GRP_ROUTE == GRP_SMEM ? GRP_SMEM_PER_SM : GRP_BLOCKS_PER_SM[GRP_ROUTE]);
}

// Bytes of scratch a pass over `cap` rows needs (reg: one partial per
// block; the atomic routes the sums' integers and scale words).
static inline long long grp_scratch_bytes(long long cap) {
  return GRP_ROUTE == GRP_REG ? static_cast<long long>(grp_grid(cap)) * GRP_E * 4
                              : GRP_FIX_CELLS * 12;
}

// Sets a kernel's dynamic shared memory limit once per process and card.
template <class K>
static cudaError_t grp_smem_limit(K kernel, long long bytes, uint64_t& ready) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (ready & bit) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) ready |= bit;
  return e;
}

// Counts into cnt[0..NB) and value k of bucket b into acc[k·NB + b] over the
// rows of [0, cap) that `rows` visits.  reg: one launch, `ticket` a zeroed
// word that each launch leaves zeroed, `scratch` at least
// grp_scratch_bytes(cap); smem and global: the accumulators' fill, the
// scale pass, the pass and the sums' finish (the scale pass and the finish
// only where the query sums), `scratch` at least grp_scratch_bytes(cap).
template <class Rows>
static cudaError_t grp_launch(const Rows& rows, long long cap, void* scratch, unsigned* ticket,
                              int* cnt, float* acc, cudaStream_t s) {
  // only the route's kernels are instantiated (if constexpr), so nvcc builds them alone
  const int grid = grp_grid(cap);
  if constexpr (GRP_ROUTE == GRP_REG) {
    grp_reg<Rows><<<grid, GRP_TPB, 0, s>>>(rows, cap, static_cast<uint32_t*>(scratch), ticket,
                                           cnt, acc);
    return cudaGetLastError();
  } else {
    long long* fx = static_cast<long long*>(scratch);
    uint32_t* sw = reinterpret_cast<uint32_t*>(fx + GRP_FIX_CELLS);
    const bool sums = grp_has_sum();
    const long long init = (GEN_NB + GRP_TPB - 1) / GRP_TPB;
    grp_init<Rows><<<static_cast<int>(init < 4096 ? init : 4096), GRP_TPB, 0, s>>>(cnt, acc, fx,
                                                                                    sw);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    constexpr bool SMEM = GRP_ROUTE == GRP_SMEM;
    static uint64_t ready_scale = 0, ready_add = 0;
    if (sums) {
      const long long bytes = SMEM ? GRP_FIX_CELLS * 4 : 0;
      e = grp_smem_limit(grp_scale<Rows, SMEM>, bytes, ready_scale);
      if (e != cudaSuccess) return e;
      grp_scale<Rows, SMEM><<<grid, GRP_TPB, static_cast<size_t>(bytes), s>>>(rows, cap, sw);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    const long long bytes = SMEM ? GRP_SMEM_FIX : 0;
    e = grp_smem_limit(grp_atomic<Rows, SMEM>, bytes, ready_add);
    if (e != cudaSuccess) return e;
    grp_atomic<Rows, SMEM><<<grid, GRP_TPB, static_cast<size_t>(bytes), s>>>(rows, cap, cnt, acc,
                                                                              fx, sw);
    e = cudaGetLastError();
    if (e != cudaSuccess || !sums) return e;
    const long long fin = (GRP_FIX_CELLS + GRP_TPB - 1) / GRP_TPB;
    grp_fix<Rows><<<static_cast<int>(fin < 4096 ? fin : 4096), GRP_TPB, 0, s>>>(acc, fx, sw, cap);
    return cudaGetLastError();
  }
}
