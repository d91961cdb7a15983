// grouped_join_agg: fused select + direct-table join + grouped aggregation
// (the TPC-H Q12 shape, and the outer join-count of Q4), generated per
// query.  The join result is never materialised.
//
// Replaces src/repro/kernels/grouped_join_agg.py:grouped_join_agg_p.  That
// kernel closed over the query's Expr (one kernel per query); on the TPU
// both the build-side lookup and the accumulation were one-hot reductions
// over the bucket axes, so the JAX package only runs it up to 4096 join
// buckets.  Here the lookup is one direct gather from a first-row table
// over the join-bucket axis, so Q4 and Q12 run it at 750,000 join buckets.
//
// This file is a template, not a library: repro_torch/kernels/codegen.py
// writes the query's row functions (its predicate over probe columns, its
// checked join buckets on both sides, the build columns' loads, its values
// and group bucket; rowfn.cuh) and appends an include of this file;
// build_generated compiles the text once per distinct query.
//
// Bound on the card: memory.  The probe rows' predicate columns and
// validity are read once, passing rows read their join key, one word of
// the first-row table and the build values they need (random reads into
// columns of a few MB, which stay in the 50 MB L2); the build side's
// validity and key columns are read once.  Q12 at sf=5: about 3.0 M probe
// rows, about 58 MB in all, about 17 us at 3.35 TB/s.
//
// Two kernels, launched in turn on the caller's stream:
//
// * the build (gja_gen_fill, then gja_gen_build): one pass over the build
//   rows.  Each valid row whose key lies in the join domain takes atomicMin
//   of its row index at its join bucket in an int32 first-row table that
//   starts at the build side's capacity (the empty bucket).  A min does not
//   depend on the order of the atomics, so the first occurrence of a
//   duplicate key wins on every run, as in runtime.build_first_index (the
//   plain version), and a build side whose rows are not buckets (Q4's,
//   a compacted inner result) needs no presence table;
// * the probe: the probe rows walked as genrows.cuh walks them (the
//   predicate first), then for the rows that pass their checked join bucket
//   (a key outside the domain drops the row), the first row there (none:
//   the row is dropped), the build columns loaded at that row in their own
//   types (integers stay exact past f32's 2^24), then the values and the
//   clipped group bucket, accumulated on grouped.cuh's route for the
//   query's shape (Q12's 7 groups × 3 words and Q4's 5 × 1 take reg: one
//   launch, a fixed-order finish, the same bits run to run).
#ifndef GEN_NJB
#error "grouped_join_agg.cu is a template: build it with repro_torch.kernels.build.build_generated"
#endif

#include "grouped.cuh"

#define GJA_BUILD_BLOCKS_PER_SM 8
// the first-row table's bytes at the start of the scratch, 16-byte aligned
constexpr long long GJA_FIRST_BYTES = (GEN_NJB * 4 + 15) / 16 * 16;

// The probe rows that are valid, pass the predicate and find a build row.
struct GjaRows {
  GenCols c;
  const uint8_t* valid;
  const int* first;  // GEN_NJB first build rows; build_cap where a bucket is empty
  int build_cap;
  template <class Visit>
  __device__ __forceinline__ void walk(long long cap, Visit&& visit) const {
    gen_walk(c, valid, cap, [&](GenRow (&r)[GEN_ROWS], uint32_t (&ok)[GEN_ROWS]) {
      int row[GEN_ROWS];
#pragma unroll
      for (int u = 0; u < GEN_ROWS; ++u) {  // the tile's lookups in flight together
        row[u] = build_cap;
        if (ok[u]) {
          const long long jb = gen_jbucket(r[u], &ok[u]);
          if (ok[u]) row[u] = __ldg(first + jb);
        }
      }
#pragma unroll
      for (int u = 0; u < GEN_ROWS; ++u) {
        ok[u] = row[u] < build_cap;
        if (ok[u]) gen_load_build(r[u], c, row[u]);
      }
      visit(r, ok);
    });
  }
};

__global__ void __launch_bounds__(GRP_TPB) gja_gen_fill(int* __restrict__ first, int build_cap) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; b < GEN_NJB;
       b += stride)
    first[b] = build_cap;
}

__global__ void __launch_bounds__(GRP_TPB)
gja_gen_build(GenCols c, const uint8_t* __restrict__ valid, long long build_cap,
              int* __restrict__ first) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; j < build_cap;
       j += stride) {
    if (!RF_LDG(valid + j)) continue;
    uint32_t ok = 1u;
    const long long b = gen_build_jbucket(c, j, &ok);
    if (ok) atomicMin(first + b, static_cast<int>(j));
  }
}

// The route this query's shape takes: 0 reg, 1 smem, 2 global.
extern "C" int gja_gen_route(void) { return GRP_ROUTE; }

// Bytes of scratch a probe over `cap` rows needs: the first-row table, then
// the route's partials.
extern "C" long long gja_gen_scratch_bytes(long long cap) {
  return GJA_FIRST_BYTES + grp_scratch_bytes(cap);
}

// The build: the first-row table of the build rows [0, build_cap) at the
// start of `scratch` (gja_gen_scratch_bytes).  build_cap must fit in an
// int32, the table's type.
extern "C" int gja_gen_build(const void* const* col_ptrs, const uint8_t* build_valid,
                             long long build_cap, void* scratch, void* stream) {
  if (build_cap < 0 || build_cap > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* first = static_cast<int*>(scratch);
  const long long fill = (GEN_NJB + GRP_TPB - 1) / GRP_TPB;
  gja_gen_fill<<<static_cast<int>(fill < 4096 ? fill : 4096), GRP_TPB, 0, s>>>(
      first, static_cast<int>(build_cap));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gja_gen_build<<<rel_grid(build_cap, GRP_TPB, GJA_BUILD_BLOCKS_PER_SM), GRP_TPB, 0, s>>>(
      gen_cols(col_ptrs), build_valid, build_cap, first);
  return cudaGetLastError();
}

// The probe, after the build on the same stream and scratch: counts into
// cnt[0..NB) and value k of group bucket b into acc[k·NB + b] over the probe
// rows of [0, cap) that are valid, pass the predicate and find a build row.
// reg: `ticket` a zeroed word that each launch leaves zeroed.
extern "C" int gja_gen_launch(const void* const* col_ptrs, const uint8_t* valid, long long cap,
                              long long build_cap, void* scratch, unsigned int* ticket, int* cnt,
                              float* acc, void* stream) {
  if (build_cap < 0 || build_cap > 0x7fffffffLL) return cudaErrorInvalidValue;
  const GjaRows rows{gen_cols(col_ptrs), valid, static_cast<const int*>(scratch),
                     static_cast<int>(build_cap)};
  return grp_launch(rows, cap, static_cast<char*>(scratch) + GJA_FIRST_BYTES, ticket, cnt, acc,
                    static_cast<cudaStream_t>(stream));
}
