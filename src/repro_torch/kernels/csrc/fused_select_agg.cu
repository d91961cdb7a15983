// fused_select_agg: single-pass select + aggregate (the TPC-H Q6 shape).
//
// Replaces src/repro/kernels/fused_select_agg.py:fused_select_agg_p, the
// Pallas kernel whose grid walked (512, 128)-lane row blocks in order and
// carried per-lane partial sums from one grid step to the next.
//
// Bound on the card: memory.  Each row is read once: the predicate's
// columns and the validity byte for every row, the aggregated columns for
// the rows that pass; the output is a few floats.  Q6 at sf=5 reads four
// f32 columns plus validity over 3.0 M rows, about 51 MB, or about 15 us at
// 3.35 TB/s.  Arithmetic is a few VM instructions per row, far below the
// card's rate.
//
// Design: one row per thread in a grid-stride loop, so neighbouring threads
// read neighbouring addresses (coalesced).  The predicate runs first and
// the aggregated expressions only for rows that pass.  Each thread keeps
// its partials in registers, a block reduces them with warp shuffles, and
// each block writes its partials to a scratch array.  A second one-block
// launch reduces the scratch in a fixed order, so for a given grid the sums
// do not depend on scheduling.  The count is int32 (an f32 count stops
// being exact at 2^24).
#include "exprvm.cuh"

__device__ __forceinline__ float warp_combine(int fn, float v) {
  for (int off = 16; off > 0; off >>= 1) v = vm_combine(fn, v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(VM_TPB)
fsa_main(const int2* __restrict__ prog, int n_pred, int n_prog, VmCols cols,
         const uint8_t* __restrict__ valid, long long cap, VmAccs accs,
         int* __restrict__ part_cnt, float* __restrict__ part_acc) {
  float acc[VM_MAX_ACC];
#pragma unroll
  for (int k = 0; k < VM_MAX_ACC; ++k) acc[k] = vm_identity(k < accs.n ? accs.fn[k] : ACC_SUM);
  int cnt = 0;
  uint32_t out[VM_MAX_OUT];
  const long long stride = static_cast<long long>(gridDim.x) * VM_TPB;
  for (long long i = blockIdx.x * static_cast<long long>(VM_TPB) + threadIdx.x; i < cap;
       i += stride) {
    if (!valid[i]) continue;
    vm_run(prog, 0, n_pred, cols, i, 0, out);
    if (!out[0]) continue;
    vm_run(prog, n_pred, n_prog, cols, i, 0, out);
    ++cnt;
#pragma unroll
    for (int k = 0; k < VM_MAX_ACC; ++k)
      if (k < accs.n) acc[k] = vm_combine(accs.fn[k], acc[k], __uint_as_float(out[1 + k]));
  }

  __shared__ float wacc[VM_TPB / 32][VM_MAX_ACC];
  __shared__ int wcnt[VM_TPB / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < VM_MAX_ACC; ++k) {
    if (k < accs.n) {
      const float v = warp_combine(accs.fn[k], acc[k]);
      if (lane == 0) wacc[warp][k] = v;
    }
  }
  cnt = warp_sum(cnt);
  if (lane == 0) wcnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < VM_TPB / 32; ++w) c += wcnt[w];
    part_cnt[blockIdx.x] = c;
    for (int k = 0; k < accs.n; ++k) {
      float v = vm_identity(accs.fn[k]);
      for (int w = 0; w < VM_TPB / 32; ++w) v = vm_combine(accs.fn[k], v, wacc[w][k]);
      part_acc[static_cast<long long>(blockIdx.x) * accs.n + k] = v;
    }
  }
}

// One block: reduce the per-block partials in a fixed order.
__global__ void __launch_bounds__(VM_TPB)
fsa_finalize(const int* __restrict__ part_cnt, const float* __restrict__ part_acc, int nblocks,
             VmAccs accs, int* __restrict__ out_cnt, float* __restrict__ out_acc) {
  __shared__ float sv[VM_TPB];
  __shared__ int sc[VM_TPB];
  int c = 0;
  for (int b = threadIdx.x; b < nblocks; b += VM_TPB) c += part_cnt[b];
  sc[threadIdx.x] = c;
  __syncthreads();
  for (int s = VM_TPB / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sc[threadIdx.x] += sc[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out_cnt[0] = sc[0];
  for (int k = 0; k < accs.n; ++k) {
    const int fn = accs.fn[k];
    float v = vm_identity(fn);
    for (int b = threadIdx.x; b < nblocks; b += VM_TPB)
      v = vm_combine(fn, v, part_acc[static_cast<long long>(b) * accs.n + k]);
    sv[threadIdx.x] = v;
    __syncthreads();
    for (int s = VM_TPB / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) sv[threadIdx.x] = vm_combine(fn, sv[threadIdx.x], sv[threadIdx.x + s]);
      __syncthreads();
    }
    if (threadIdx.x == 0) out_acc[k] = sv[0];
    __syncthreads();
  }
}

// Blocks per SM of fsa_main.  The wrapper reads it to size the per-block
// partials: `max_blocks` = SMs x this.
extern "C" const int fsa_blocks_per_sm = 8;

extern "C" int fsa_launch(const int2* prog, int n_pred, int n_prog, const void* const* col_ptrs,
                          const int* col_types, const int* col_src, int n_cols,
                          const uint8_t* valid, long long cap, const int* fns, int n_acc,
                          int* part_cnt, float* part_acc, int max_blocks, int* out_cnt,
                          float* out_acc, void* stream) {
  const int grid = vm_grid(cap, fsa_blocks_per_sm);
  if (n_cols > VM_MAX_COLS || n_acc > VM_MAX_ACC || grid > max_blocks)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const VmCols cols = vm_make_cols(col_ptrs, col_types, col_src, n_cols);
  const VmAccs accs = vm_make_accs(fns, n_acc);
  fsa_main<<<grid, VM_TPB, 0, s>>>(prog, n_pred, n_prog, cols, valid, cap, accs, part_cnt,
                                   part_acc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fsa_finalize<<<1, VM_TPB, 0, s>>>(part_cnt, part_acc, grid, accs, out_cnt, out_acc);
  return cudaGetLastError();
}
