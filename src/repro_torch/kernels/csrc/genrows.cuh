// genrows.cuh: how the generated kernels (fused_select_agg.cu,
// grouped_select_agg.cu, grouped_join_agg.cu's probe) walk a table's rows,
// after the query's row functions (codegen.py, rowfn.cuh) and before the
// kernel that includes it.
//
// A persistent grid; each warp takes tiles of 32·GEN_ROWS consecutive
// rows, lane l rows l, l + 32, ... of a tile, so every column load of a
// warp reads consecutive addresses (128 bytes of a 4-byte column, 32 of
// the validity bytes).  A tile's validity bytes and predicate columns are
// all loaded before the first use, then the predicate runs, then the rows
// that pass load the other columns, and visit(r, ok) adds them.  Only the
// last tile checks the row bound.  Every lane of a warp calls visit
// together, so it may use the warp's shuffles.
//
// Validity is read a byte per lane.  An intermediate version read it as
// 16-byte vectors (16 rows a lane, spread to the lanes by shuffles, tiles
// of 512 rows in four batches): on the H100 it made fused_select_agg and
// the reg route slower and nvcc about 2.7 times slower (PERF.md §6),
// so the byte loads stay.
#pragma once

#include <cstdint>

#define GEN_ROWS 4

template <bool FULL>
__device__ __forceinline__ void gen_tile(const GenCols& c, const uint8_t* __restrict__ valid,
                                         long long base, long long cap, int lane,
                                         GenRow (&r)[GEN_ROWS], uint32_t (&ok)[GEN_ROWS]) {
#pragma unroll
  for (int u = 0; u < GEN_ROWS; ++u) {
    const long long i = base + 32 * u + lane;
    if (FULL || i < cap) {
      ok[u] = RF_LDG(valid + i);
      gen_load_pred(r[u], c, i);
    } else {
      ok[u] = 0;
      r[u] = GenRow{};
    }
  }
#pragma unroll
  for (int u = 0; u < GEN_ROWS; ++u) ok[u] &= gen_pred(r[u]);
#pragma unroll
  for (int u = 0; u < GEN_ROWS; ++u)
    if (ok[u]) gen_load_rest(r[u], c, base + 32 * u + lane);
}

// Rows of a block's pass, for the launch's grid size.
#define GEN_BLOCK_ROWS(tpb) (static_cast<long long>(tpb) * GEN_ROWS)

template <class Visit>
__device__ __forceinline__ void gen_walk(const GenCols& c, const uint8_t* __restrict__ valid,
                                         long long cap, Visit&& visit) {
  const int lane = threadIdx.x & 31;
  constexpr long long STEP = 32LL * GEN_ROWS;
  const long long stride = static_cast<long long>(gridDim.x) * (blockDim.x / 32) * STEP;
  long long base =
      (static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5)) * STEP;
  GenRow r[GEN_ROWS];
  uint32_t ok[GEN_ROWS];
  for (; base + STEP <= cap; base += stride) {
    gen_tile<true>(c, valid, base, cap, lane, r, ok);
    visit(r, ok);
  }
  if (base < cap) {
    gen_tile<false>(c, valid, base, cap, lane, r, ok);
    visit(r, ok);
  }
}
