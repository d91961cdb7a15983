// grouped_select_agg: fused select + dense-bucket grouped aggregation (the
// TPC-H Q1 shape, and the per-order count inside Q4), generated per query.
//
// Replaces src/repro/kernels/grouped_select_agg.py:grouped_select_agg_p.
// That kernel closed over the query's Expr (one kernel per query) and,
// having no cheap scatter on the TPU, built a one-hot over the bucket axis
// for every row block and reduced it; the JAX package sends anything over
// 4096 buckets elsewhere.  Here the bucket count is limited only by device
// memory (Q4 runs it at 750,000 buckets).
//
// This file is a template, not a library: repro_torch/kernels/codegen.py
// writes the query's row functions and bucket id (rowfn.cuh) and appends
// an include of this file; build_generated compiles the text once per
// distinct query.
//
// Bound on the card: memory.  The rows' predicate columns and validity
// are read once, the key and value columns for the rows that pass, and
// the accumulators are written once (Q1 at sf=5: about 73 MB, about 22 us
// at 3.35 TB/s).
//
// Rows are read as genrows.cuh walks them (as in fused_select_agg.cu): a
// persistent grid, warps on tiles of consecutive rows, a tile's loads in
// flight before the first use, the predicate first, the other columns for
// the rows that pass.  Then one of three routes, fixed by the
// query's shape (GEN_NB buckets, GEN_NV values), never on failure:
//
// * reg, when NB·(1 + NV) accumulators fit in GSA_REG_BUDGET registers
//   (Q1: 6 buckets × 5): each thread keeps every bucket's count and
//   values in registers and adds a row into its bucket by an unrolled
//   compare against each bucket id (the TPU's one-hot, held in
//   registers); then the xor-shuffle and warp-order block reduction and
//   the fixed-order finish of relagg.cuh.  No atomics, one launch, the
//   same bits on every run for a given grid;
// * smem, when the accumulators fit in 48 KB of shared memory: each
//   block keeps a private copy and flushes the buckets it touched into
//   the global accumulators at the end;
// * global, for more buckets (Q4: 750,000): atomics on the global
//   accumulators.
//
// On the two atomic routes a warp first merges its lanes that add into
// the same bucket (__match_any_sync; the lowest lane of each group adds
// the group's count and values with one atomic each), since lineitem is
// generated clustered by order key and neighbouring rows often share a
// bucket.  Float sums are then added in an order that changes from run
// to run; float min/max use the sign-aware integer atomics of relagg.cuh;
// the global accumulators are filled with each aggregate's identity by a
// first launch.  Counts are int32 (an f32 count stops being exact at
// 2^24).
#ifndef GEN_NB
#error "grouped_select_agg.cu is a template: build it with repro_torch.kernels.build.build_generated"
#endif

#include "genrows.cuh"
#include "relagg.cuh"

#define GSA_TPB 256
// accumulators (counts and values) a thread may hold on the reg route
#define GSA_REG_BUDGET 64
#define GSA_SMEM_BYTES (48 * 1024)

enum { GSA_REG = 0, GSA_SMEM = 1, GSA_GLOBAL = 2 };
constexpr long long GSA_ACCS = GEN_NB * (1 + GEN_NV);
constexpr int GSA_ROUTE = GSA_ACCS <= GSA_REG_BUDGET ? GSA_REG
                          : (GSA_ACCS * 4 <= GSA_SMEM_BYTES ? GSA_SMEM : GSA_GLOBAL);
// the reg route's buckets and partial words per block
constexpr int GSA_RNB = GSA_ROUTE == GSA_REG ? static_cast<int>(GEN_NB) : 1;
constexpr int GSA_E = GSA_RNB * (1 + GEN_NV);
constexpr int GSA_BLOCKS_PER_SM[3] = {2, 4, 8};

// ---- reg -------------------------------------------------------------------

struct GsaComb {
  __device__ __forceinline__ uint32_t operator()(int e, uint32_t a, uint32_t b) const {
    if (e < GSA_RNB) return a + b;
    return __float_as_uint(
        gen_comb((e - GSA_RNB) / GSA_RNB, __uint_as_float(a), __uint_as_float(b)));
  }
};

__global__ void __launch_bounds__(GSA_TPB, 2)
gsa_gen_reg(GenCols c, const uint8_t* __restrict__ valid, long long cap,
            uint32_t* __restrict__ part, unsigned* ticket, int* __restrict__ out_cnt,
            float* __restrict__ out_acc) {
  int cnt[GSA_RNB];
  float acc[GSA_RNB][GEN_NV1];
#pragma unroll
  for (int b = 0; b < GSA_RNB; ++b) {
    cnt[b] = 0;
#pragma unroll
    for (int k = 0; k < GEN_NV1; ++k) acc[b][k] = gen_ident(k);
  }
  // each row into its bucket by an unrolled compare against every bucket id
  gen_walk(c, valid, cap, [&](GenRow (&r)[GEN_ROWS], uint32_t (&ok)[GEN_ROWS]) {
#pragma unroll
    for (int u = 0; u < GEN_ROWS; ++u) {
      if (!ok[u]) continue;
      float v[GEN_NV1];
      gen_values(r[u], v);
      const long long bucket = gen_bucket(r[u]);
#pragma unroll
      for (int b = 0; b < GSA_RNB; ++b) {
        const bool hit = bucket == b;
        cnt[b] += hit;
#pragma unroll
        for (int k = 0; k < GEN_NV; ++k) acc[b][k] = hit ? gen_comb(k, acc[b][k], v[k]) : acc[b][k];
      }
    }
  });

  // words: the counts of buckets 0..NB-1, then value k of bucket b at NB·(1 + k) + b
  uint32_t w[GSA_E];
#pragma unroll
  for (int b = 0; b < GSA_RNB; ++b) {
    w[b] = static_cast<uint32_t>(cnt[b]);
#pragma unroll
    for (int k = 0; k < GEN_NV; ++k) w[GSA_RNB * (1 + k) + b] = __float_as_uint(acc[b][k]);
  }
  rel_block_partials<GSA_E, GSA_TPB>(w, part, GsaComb());
  if (!rel_last_block(ticket)) return;
  rel_finish<GSA_E, GSA_TPB>(part, GsaComb(), [&](int e, uint32_t v) {
    if (e < GSA_RNB) out_cnt[e] = static_cast<int>(v);
    else out_acc[e - GSA_RNB] = __uint_as_float(v);
  });
}

// ---- smem and global ---------------------------------------------------------

// Adds one row per lane (bucket < 0: none) into cnt/acc, after merging the
// lanes of the warp that add into the same bucket: each lane sums its
// group's values in lane order, and the group's lowest lane adds them.
// Every lane of the warp calls it.
__device__ __forceinline__ void gsa_merge_add(long long bucket, float (&v)[GEN_NV1], int* cnt,
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

template <bool SMEM>
__global__ void __launch_bounds__(GSA_TPB)
gsa_gen_atomic(GenCols c, const uint8_t* __restrict__ valid, long long cap, int* __restrict__ cnt,
               float* __restrict__ acc) {
  extern __shared__ uint32_t smem[];
  int* tcnt = cnt;
  float* tacc = acc;
  if (SMEM) {
    tcnt = reinterpret_cast<int*>(smem);
    tacc = reinterpret_cast<float*>(smem + GEN_NB);
    for (long long b = threadIdx.x; b < GEN_NB; b += GSA_TPB) {
      tcnt[b] = 0;
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) tacc[k * GEN_NB + b] = gen_ident(k);
    }
    __syncthreads();
  }
  gen_walk(c, valid, cap, [&](GenRow (&r)[GEN_ROWS], uint32_t (&ok)[GEN_ROWS]) {
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
      gsa_merge_add(bucket, v, tcnt, tacc, GEN_NB);
    }
  });
  if (SMEM) {
    __syncthreads();
    for (long long b = threadIdx.x; b < GEN_NB; b += GSA_TPB) {
      const int n = tcnt[b];
      if (n == 0) continue;
      atomicAdd(cnt + b, n);
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) rel_atomic(gen_fn(k), acc + k * GEN_NB + b, tacc[k * GEN_NB + b]);
    }
  }
}

// Fills the global accumulators: counts 0, each value its identity.
__global__ void gsa_gen_init(int* __restrict__ cnt, float* __restrict__ acc) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; b < GEN_NB;
       b += stride) {
    cnt[b] = 0;
#pragma unroll
    for (int k = 0; k < GEN_NV; ++k) acc[k * GEN_NB + b] = gen_ident(k);
  }
}

static inline int gsa_grid(long long cap) {
  return rel_grid(cap, GEN_BLOCK_ROWS(GSA_TPB), GSA_BLOCKS_PER_SM[GSA_ROUTE]);
}

// The route this query's shape takes: 0 reg, 1 smem, 2 global.
extern "C" int gsa_gen_route(void) { return GSA_ROUTE; }

// Bytes of scratch a launch over `cap` rows needs (reg: one partial per
// block; the atomic routes none).
extern "C" long long gsa_gen_scratch_bytes(long long cap) {
  return GSA_ROUTE == GSA_REG ? static_cast<long long>(gsa_grid(cap)) * GSA_E * 4 : 0;
}

// Counts into cnt[0..NB) and value k of bucket b into acc[k·NB + b] over the
// rows of [0, cap) that are valid and pass the predicate.  reg: one launch,
// `ticket` a zeroed word that each launch leaves zeroed, `scratch` at least
// gsa_gen_scratch_bytes(cap); smem and global: the accumulators' fill, then
// the pass.
extern "C" int gsa_gen_launch(const void* const* col_ptrs, const uint8_t* valid, long long cap,
                              void* scratch, unsigned int* ticket, int* cnt, float* acc,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GenCols c = gen_cols(col_ptrs);
  const int grid = gsa_grid(cap);
  if (GSA_ROUTE == GSA_REG) {
    gsa_gen_reg<<<grid, GSA_TPB, 0, s>>>(c, valid, cap, static_cast<uint32_t*>(scratch), ticket,
                                          cnt, acc);
    return cudaGetLastError();
  }
  const long long init = (GEN_NB + GSA_TPB - 1) / GSA_TPB;
  gsa_gen_init<<<static_cast<int>(init < 4096 ? init : 4096), GSA_TPB, 0, s>>>(cnt, acc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (GSA_ROUTE == GSA_SMEM)
    gsa_gen_atomic<true><<<grid, GSA_TPB, static_cast<size_t>(GSA_ACCS * 4), s>>>(c, valid, cap,
                                                                                 cnt, acc);
  else
    gsa_gen_atomic<false><<<grid, GSA_TPB, 0, s>>>(c, valid, cap, cnt, acc);
  return cudaGetLastError();
}
