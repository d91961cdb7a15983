// fused_select_agg: single-pass select + aggregate (the TPC-H Q6 shape),
// generated per query.
//
// Replaces src/repro/kernels/fused_select_agg.py:fused_select_agg_p, the
// Pallas kernel that closes over the query's Expr (one kernel per query)
// and whose grid walked (512, 128)-lane row blocks in order, carrying
// per-lane partial sums from one grid step to the next.
//
// This file is a template, not a library: repro_torch/kernels/codegen.py
// writes the query's row functions (gen_pred, gen_values, ...; see
// rowfn.cuh) and appends an include of this file, and build_generated
// compiles the text once per distinct query.
//
// Bound on the card: memory.  Each row is read once: the predicate's
// columns and the validity byte for every row, the columns only the
// aggregated values read for the rows that pass; the output is a few
// words.  Q6 at sf=5 reads three f32 columns plus validity over 3.0 M
// rows and the price of the 2 % that pass, about 39 MB, about 12 us at
// 3.35 TB/s.  The arithmetic is a few instructions per row.
//
// Design:
// * straight-line code in registers: the predicate and each value are
//   functions of the row's loaded columns, with the query's constants as
//   literals (no interpreter, no stack, no program in memory);
// * a persistent grid (FSA_BLOCKS_PER_SM blocks of FSA_TPB threads per
//   SM) walking the rows as genrows.cuh does: warps on tiles of
//   consecutive rows, a tile's validity and predicate columns loaded
//   before the first use with consecutive addresses across a warp, the
//   predicate first, the other columns for the rows that pass;
// * each thread's partials (the int32 count, one f32 per value) in
//   registers, reduced by xor shuffles and then the warps in order, one
//   partial per block; the last block to take the ticket adds the
//   blocks' partials in a fixed order and writes the result (relagg.cuh),
//   an empty min/max's ±3e38 sentinel as ±inf.  One launch, and for a
//   given grid the sums do not depend on scheduling: two runs give the
//   same bits.
#ifndef GEN_NV
#error "fused_select_agg.cu is a template: build it with repro_torch.kernels.build.build_generated"
#endif

#include "genrows.cuh"
#include "relagg.cuh"

#define FSA_TPB 256
#define FSA_BLOCKS_PER_SM 4
// partial words per block: the count, then each value's f32 bits
#define FSA_E (1 + GEN_NV)

struct FsaComb {
  __device__ __forceinline__ uint32_t operator()(int e, uint32_t a, uint32_t b) const {
    if (e == 0) return a + b;
    return __float_as_uint(gen_comb(e - 1, __uint_as_float(a), __uint_as_float(b)));
  }
};

__global__ void __launch_bounds__(FSA_TPB)
fsa_gen(GenCols c, const uint8_t* __restrict__ valid, long long cap, uint32_t* __restrict__ part,
        unsigned* ticket, int* __restrict__ out_cnt, float* __restrict__ out_acc) {
  float acc[GEN_NV1];
#pragma unroll
  for (int k = 0; k < GEN_NV1; ++k) acc[k] = gen_ident(k);
  int cnt = 0;
  gen_walk(c, valid, cap, [&](GenRow (&r)[GEN_ROWS], uint32_t (&ok)[GEN_ROWS]) {
#pragma unroll
    for (int u = 0; u < GEN_ROWS; ++u) {
      if (!ok[u]) continue;
      float v[GEN_NV1];
      gen_values(r[u], v);
      ++cnt;
#pragma unroll
      for (int k = 0; k < GEN_NV; ++k) acc[k] = gen_comb(k, acc[k], v[k]);
    }
  });

  uint32_t w[FSA_E];
  w[0] = static_cast<uint32_t>(cnt);
#pragma unroll
  for (int k = 0; k < GEN_NV; ++k) w[1 + k] = __float_as_uint(acc[k]);
  rel_block_partials<FSA_E, FSA_TPB>(w, part, FsaComb());
  if (!rel_last_block(ticket)) return;
  rel_finish<FSA_E, FSA_TPB>(part, FsaComb(), [&](int e, uint32_t v) {
    const float f = __uint_as_float(v);  // an empty min/max's sentinel as ±inf
    if (e == 0) out_cnt[0] = static_cast<int>(v);
    else out_acc[e - 1] = f >= RF_POS ? INFINITY : (f <= RF_NEG ? -INFINITY : f);
  });
}

static inline int fsa_grid(long long cap) {
  return rel_grid(cap, GEN_BLOCK_ROWS(FSA_TPB), FSA_BLOCKS_PER_SM);
}

// Bytes of scratch a launch over `cap` rows needs: one partial per block.
extern "C" long long fsa_gen_scratch_bytes(long long cap) {
  return static_cast<long long>(fsa_grid(cap)) * FSA_E * 4;
}

// One launch: count and values of the rows of [0, cap) that are valid and
// pass the predicate, into out_cnt[0] and out_acc[0..GEN_NV).  `ticket` is
// a zeroed word that each launch leaves zeroed; `scratch` holds at least
// fsa_gen_scratch_bytes(cap).
extern "C" int fsa_gen_launch(const void* const* col_ptrs, const uint8_t* valid, long long cap,
                              void* scratch, unsigned int* ticket, int* out_cnt, float* out_acc,
                              void* stream) {
  fsa_gen<<<fsa_grid(cap), FSA_TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      gen_cols(col_ptrs), valid, cap, static_cast<uint32_t*>(scratch), ticket, out_cnt, out_acc);
  return cudaGetLastError();
}
