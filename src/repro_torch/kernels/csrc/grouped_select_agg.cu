// grouped_select_agg: fused select + dense-bucket grouped aggregation (the
// TPC-H Q1 shape, and the per-order count inside Q4).
//
// Replaces src/repro/kernels/grouped_select_agg.py:grouped_select_agg_p.
// That kernel had no cheap scatter on the TPU, so it built a one-hot over
// the bucket axis for every row block and reduced it; its cost grew with
// the number of buckets, and the JAX package sends anything over 4096
// buckets elsewhere.  Hopper has fast shared-memory and global atomics, so
// each row adds straight into its bucket and the bucket count is limited
// only by device memory (Q4 runs it at 750,000 buckets).
//
// Bound on the card: memory.  The rows' columns and validity are read once
// (Q1 at sf=5: seven 4-byte columns plus validity over 3.0 M rows, about
// 87 MB, about 26 us at 3.35 TB/s) and the accumulators are written once.
//
// Design: one row per thread in a grid-stride loop (coalesced reads).  The
// predicate runs first; a passing row evaluates its aggregated expressions
// and its bucket id (keys clipped to their static domains) and adds into
// the bucket.  When the counts and accumulators of all buckets fit in 48 KB
// (Q1: 6 buckets), each block keeps a private copy in shared memory, adds
// there with shared atomics and flushes the buckets it touched to the
// global ones at the end; otherwise rows add into the global accumulators
// directly.  Counts are int32 (an f32 count stops being exact at 2^24).
// Float min/max use the sign-aware integer atomics of exprvm.cuh.  Float
// sums are added in an order that changes from run to run.
#include "exprvm.cuh"

template <bool SMEM>
__global__ void __launch_bounds__(VM_TPB)
gsa_main(const int2* __restrict__ prog, int n_pred, int n_prog, VmCols cols,
         const uint8_t* __restrict__ valid, long long cap, VmKeys keys, VmAccs accs,
         long long nb, int* __restrict__ cnt, float* __restrict__ acc) {
  extern __shared__ uint32_t smem[];
  int* scnt = reinterpret_cast<int*>(smem);
  float* sacc = reinterpret_cast<float*>(smem + (SMEM ? nb : 0));
  if (SMEM) {
    vm_init_shared(scnt, sacc, nb, accs);
    __syncthreads();
  }
  int* tcnt = SMEM ? scnt : cnt;
  float* tacc = SMEM ? sacc : acc;
  uint32_t out[VM_MAX_OUT];
  const long long stride = static_cast<long long>(gridDim.x) * VM_TPB;
  for (long long i = blockIdx.x * static_cast<long long>(VM_TPB) + threadIdx.x; i < cap;
       i += stride) {
    if (!valid[i]) continue;
    vm_run(prog, 0, n_pred, cols, i, 0, out);
    if (!out[0]) continue;
    vm_run(prog, n_pred, n_prog, cols, i, 0, out);
    bool ok = true;
    const long long b = vm_bucket(keys, cols, i, 0, &ok);
    atomicAdd(tcnt + b, 1);
    for (int k = 0; k < accs.n; ++k)
      vm_atomic(accs.fn[k], tacc + k * nb + b, __uint_as_float(out[1 + k]));
  }
  if (SMEM) {
    __syncthreads();
    vm_flush(scnt, sacc, cnt, acc, nb, accs);
  }
}

extern "C" int gsa_launch(const int2* prog, int n_pred, int n_prog, const void* const* col_ptrs,
                          const int* col_types, const int* col_src, int n_cols,
                          const uint8_t* valid, long long cap, const int* key_slots,
                          const long long* key_lo, const long long* key_size, int n_keys,
                          const int* fns, int n_acc, long long nb, int* cnt, float* acc,
                          void* stream) {
  if (n_cols > VM_MAX_COLS || n_acc > VM_MAX_ACC || n_keys > VM_MAX_KEYS || nb < 1)
    return cudaErrorInvalidValue;
  const long long smem = vm_smem_bytes(nb, n_acc);
  const int grid = vm_grid(cap, smem ? VM_SMEM_BLOCKS_PER_SM : VM_GLOBAL_BLOCKS_PER_SM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const VmCols cols = vm_make_cols(col_ptrs, col_types, col_src, n_cols);
  const VmKeys keys = vm_make_keys(key_slots, key_lo, key_size, n_keys);
  const VmAccs accs = vm_make_accs(fns, n_acc);
  const long long init_blocks = (nb + VM_TPB - 1) / VM_TPB;
  vm_init_accumulators<<<static_cast<int>(init_blocks < 4096 ? init_blocks : 4096), VM_TPB, 0, s>>>(
      cnt, acc, nb, accs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (smem)
    gsa_main<true><<<grid, VM_TPB, static_cast<size_t>(smem), s>>>(
        prog, n_pred, n_prog, cols, valid, cap, keys, accs, nb, cnt, acc);
  else
    gsa_main<false><<<grid, VM_TPB, 0, s>>>(prog, n_pred, n_prog, cols, valid, cap, keys, accs,
                                            nb, cnt, acc);
  return cudaGetLastError();
}
