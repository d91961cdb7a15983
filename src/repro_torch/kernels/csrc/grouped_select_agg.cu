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
// the rows that pass.  Then one of three routes (reg, smem, global), fixed
// by the query's shape and shared with grouped_join_agg.cu: grouped.cuh
// describes them.
#ifndef GEN_NB
#error "grouped_select_agg.cu is a template: build it with repro_torch.kernels.build.build_generated"
#endif

#include "grouped.cuh"

// The rows of one table that are valid and pass the predicate.
struct GsaRows {
  GenCols c;
  const uint8_t* valid;
  template <class Visit>
  __device__ __forceinline__ void walk(long long cap, Visit&& visit) const {
    gen_walk(c, valid, cap, visit);
  }
};

// The route this query's shape takes: 0 reg, 1 smem, 2 global.
extern "C" int gsa_gen_route(void) { return GRP_ROUTE; }

// Bytes of scratch a launch over `cap` rows needs (reg: one partial per
// block; the atomic routes none).
extern "C" long long gsa_gen_scratch_bytes(long long cap) { return grp_scratch_bytes(cap); }

// Counts into cnt[0..NB) and value k of bucket b into acc[k·NB + b] over the
// rows of [0, cap) that are valid and pass the predicate.  reg: one launch,
// `ticket` a zeroed word that each launch leaves zeroed, `scratch` at least
// gsa_gen_scratch_bytes(cap); smem and global: the accumulators' fill, then
// the pass.
extern "C" int gsa_gen_launch(const void* const* col_ptrs, const uint8_t* valid, long long cap,
                              void* scratch, unsigned int* ticket, int* cnt, float* acc,
                              void* stream) {
  return grp_launch(GsaRows{gen_cols(col_ptrs), valid}, cap, scratch, ticket, cnt, acc,
                    static_cast<cudaStream_t>(stream));
}
