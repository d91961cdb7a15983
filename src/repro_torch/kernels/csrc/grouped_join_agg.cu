// grouped_join_agg: fused select + direct-table join + grouped aggregation
// (the TPC-H Q12 shape, and the outer join-count of Q4).  The join result
// is never materialised.
//
// Replaces src/repro/kernels/grouped_join_agg.py:grouped_join_agg_p.  On
// the TPU both the build-side lookup and the accumulation were one-hot
// reductions over the bucket axes, so the JAX package only runs it up to
// 4096 join buckets.  Here the lookup is one direct gather from dense
// per-join-bucket tables and the accumulation uses atomics, so Q4 and Q12
// run it at 750,000 join buckets.
//
// The build side is condensed outside the kernel, in torch, into a
// presence table and one table per needed build column over the join-bucket
// axis (first occurrence of a duplicate key wins).  The tables keep the
// columns' own types, so integer values stay exact past f32's 2^24.
//
// Bound on the card: memory.  The probe rows' predicate columns and
// validity are read once; passing rows read their key, one presence byte
// and the build values they need (random reads into tables of a few MB,
// which stay in the 50 MB L2).  Q12 at sf=5: about 3.0 M probe rows over
// four 4-byte predicate columns plus validity, about 51 MB, about 15 us at
// 3.35 TB/s.
//
// Design: one probe row per thread in a grid-stride loop.  The predicate
// (probe columns only) runs first; a passing row computes its checked join
// bucket (a key outside the declared domain drops the row), reads the
// presence table, then evaluates the aggregated expressions with build
// columns gathered at that bucket, packs its group bucket (clipped, over
// probe or build columns) and adds into it: shared-memory accumulators when
// all buckets fit in 48 KB (Q12: 7 groups, Q4: 5), global atomics
// otherwise.  Counts are int32; float sums are added in an order that
// changes from run to run.
#include "exprvm.cuh"

template <bool SMEM>
__global__ void __launch_bounds__(VM_TPB)
gja_main(const int2* __restrict__ prog, int n_pred, int n_prog, VmCols cols,
         const uint8_t* __restrict__ valid, long long cap, VmKeys jkeys,
         const uint8_t* __restrict__ present, VmKeys gkeys, VmAccs accs, long long nb,
         int* __restrict__ cnt, float* __restrict__ acc) {
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
    bool ok = true;
    const long long jb = vm_bucket(jkeys, cols, i, 0, &ok);
    if (!ok || !__ldg(present + jb)) continue;
    vm_run(prog, n_pred, n_prog, cols, i, jb, out);
    const long long b = vm_bucket(gkeys, cols, i, jb, &ok);
    atomicAdd(tcnt + b, 1);
    for (int k = 0; k < accs.n; ++k)
      vm_atomic(accs.fn[k], tacc + k * nb + b, __uint_as_float(out[1 + k]));
  }
  if (SMEM) {
    __syncthreads();
    vm_flush(scnt, sacc, cnt, acc, nb, accs);
  }
}

extern "C" int gja_launch(const int2* prog, int n_pred, int n_prog, const void* const* col_ptrs,
                          const int* col_types, const int* col_src, int n_cols,
                          const uint8_t* valid, long long cap, const int* jkey_slots,
                          const long long* jkey_lo, const long long* jkey_size, int n_jkeys,
                          const uint8_t* present, const int* gkey_slots,
                          const long long* gkey_lo, const long long* gkey_size, int n_gkeys,
                          const int* fns, int n_acc, long long nb, int* cnt, float* acc,
                          void* stream) {
  if (n_cols > VM_MAX_COLS || n_acc > VM_MAX_ACC || n_jkeys > VM_MAX_KEYS ||
      n_gkeys > VM_MAX_KEYS || nb < 1)
    return cudaErrorInvalidValue;
  const long long smem = vm_smem_bytes(nb, n_acc);
  const int grid = vm_grid(cap, smem ? VM_SMEM_BLOCKS_PER_SM : VM_GLOBAL_BLOCKS_PER_SM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const VmCols cols = vm_make_cols(col_ptrs, col_types, col_src, n_cols);
  const VmKeys jkeys = vm_make_keys(jkey_slots, jkey_lo, jkey_size, n_jkeys);
  const VmKeys gkeys = vm_make_keys(gkey_slots, gkey_lo, gkey_size, n_gkeys);
  const VmAccs accs = vm_make_accs(fns, n_acc);
  const long long init_blocks = (nb + VM_TPB - 1) / VM_TPB;
  vm_init_accumulators<<<static_cast<int>(init_blocks < 4096 ? init_blocks : 4096), VM_TPB, 0, s>>>(
      cnt, acc, nb, accs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (smem)
    gja_main<true><<<grid, VM_TPB, static_cast<size_t>(smem), s>>>(
        prog, n_pred, n_prog, cols, valid, cap, jkeys, present, gkeys, accs, nb, cnt, acc);
  else
    gja_main<false><<<grid, VM_TPB, 0, s>>>(prog, n_pred, n_prog, cols, valid, cap, jkeys,
                                            present, gkeys, accs, nb, cnt, acc);
  return cudaGetLastError();
}
