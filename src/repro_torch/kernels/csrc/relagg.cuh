// relagg.cuh: pieces the relational kernels share: float min/max atomics,
// the grid of a pass over rows, and the fixed-order reduction of per-thread
// partials: within a block, then across blocks behind an acquire-release
// ticket.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

// Float min/max by integer atomics: a non-negative float orders like its
// int bits, a negative one in reverse order of its unsigned bits.
__device__ __forceinline__ void rel_atomic_min(float* a, float v) {
  if (!signbit(v)) atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMax(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

__device__ __forceinline__ void rel_atomic_max(float* a, float v) {
  if (!signbit(v)) atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

// fn: 1 min, 2 max (gen_fn's codes, codegen._FN); a sum (0) takes
// fixsum.cuh's integers instead, whose bits do not depend on the order
__device__ __forceinline__ void rel_atomic(int fn, float* a, float v) {
  if (fn == 1) rel_atomic_min(a, v);
  else rel_atomic_max(a, v);
}

// Blocks of a pass over `rows` rows, `rows_per_block` at a time: at most
// `per_sm` on each SM of the current device, at least one.
static inline int rel_grid(long long rows, long long rows_per_block, int per_sm) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (rows + rows_per_block - 1) / rows_per_block;
  const long long most = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(need < 1 ? 1 : (need < most ? need : most));
}

// Takes the block's turn on `ticket` after its partials are written; true
// in the last block of the grid.  Thread 0's acquire-release increment
// after the barrier orders the block's writes before it and the last
// block's reads after it, and wraps the ticket back to 0 for the next
// launch (hopper.cuh's atom_inc_acq_rel, as kmeans_step's finish uses).
__device__ __forceinline__ bool rel_last_block(unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0)
    last = hop::atom_inc_acq_rel(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// The last block adds the grid's partials part[b * E + e] (32-bit words)
// in a fixed order: runs of consecutive blocks, one run per thread with
// its loads in flight, then the runs in order; store(e, word) writes each
// result.  comb(e, a, b) adds two words of element e.  For a given grid the
// result does not depend on scheduling.
template <int E, int TPB, class Comb, class Store>
__device__ __forceinline__ void rel_finish(const uint32_t* part, Comb comb, Store store) {
  constexpr int RUNS = 32;
  __shared__ uint32_t runs[E][RUNS];
  const int blocks = gridDim.x;
  const int run = (blocks + RUNS - 1) / RUNS;
  const int nruns = (blocks + run - 1) / run;
  for (int p = threadIdx.x; p < E * nruns; p += TPB) {
    const int e = p / nruns, q = p % nruns;
    const int b0 = q * run, b1 = min(blocks, b0 + run);
    uint32_t v = __ldcg(part + static_cast<size_t>(b0) * E + e);
#pragma unroll 8
    for (int b = b0 + 1; b < b1; ++b) v = comb(e, v, __ldcg(part + static_cast<size_t>(b) * E + e));
    runs[e][q] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += TPB) {
    uint32_t v = runs[e][0];
    for (int q = 1; q < nruns; ++q) v = comb(e, v, runs[e][q]);
    store(e, v);
  }
}

// Reduces each thread's E words over the block in a fixed order (xor
// shuffles within each warp, then the warps in order) and writes the
// block's partials to part[blockIdx.x * E + e].
template <int E, int TPB, class Comb>
__device__ __forceinline__ void rel_block_partials(uint32_t (&w)[E], uint32_t* part, Comb comb) {
  __shared__ uint32_t wpart[TPB / 32][E];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < E; ++e) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w[e] = comb(e, w[e], __shfl_xor_sync(0xffffffffu, w[e], off));
    if (lane == 0) wpart[warp][e] = w[e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += TPB) {
    uint32_t v = wpart[0][e];
    for (int m = 1; m < TPB / 32; ++m) v = comb(e, v, wpart[m][e]);
    part[static_cast<size_t>(blockIdx.x) * E + e] = v;
  }
}
