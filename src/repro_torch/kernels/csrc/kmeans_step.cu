// kmeans_step: one k-means step, assignment and accumulation fused.
//
// Replaces src/repro/kernels/kmeans_step.py:kmeans_step_p.  That kernel ran
// both halves on the TPU's matrix unit: d² through an x·cᵀ product, and the
// accumulation as one_hot(labels)ᵀ·x; its wrapper padded the rows to the
// block size with copies of c[0] and took them off the sums afterwards.
// Hopper needs neither the one-hot nor the padding: each point adds straight
// into its centroid's accumulators, and the grid-stride loop stops at n.
//
// Bound on the card: memory.  The points are read once (n = 2^24, d = 8:
// 537 MB, about 0.16 ms at 3.35 TB/s); the n·k·(2d+3) f32 operations (5.1e9
// at k = 16, about 0.08 ms at 67 TFLOP/s) stay below that.  The likely limit
// of this first design is neither: every point of a block adds into the
// same k·d shared addresses, and those atomics contend.
//
// Design: one thread per point in a grid-stride loop.  Each block copies the
// centroids into shared memory and computes ‖c_j‖² once.  A thread loads its
// point's d values into registers, forms ‖x‖² and each x·c_j as sums in
// index order, d² = (‖x‖² − 2·x·c_j) + ‖c_j‖² with the _rn intrinsics (the
// build runs --fmad=false), and keeps the first minimum (strict <, from
// j = 0), so duplicate centroids resolve to the lowest index as jnp.argmin
// does.  No tensor cores: labels must agree with an f32 reference.  Sums go
// into per-block shared accumulators (k·d f32) and counts into int32 shared
// counts, flushed once per block with global atomics.  When accumulators and
// centroids together pass the opt-in shared memory (227 KB on sm_90), only
// the centroids stay in shared memory and points add into the global
// accumulators.  Counts are int32 (an f32 count is inexact past 2^24); the
// wrapper returns them as f32.  Sums are added in an order that changes from
// run to run.
#include <cuda_runtime.h>

#define KMS_TPB 256
#define KMS_MAX_D 128
#define KMS_BLOCKS_PER_SM 4
// what kms_launch returns when the centroid table passes the opt-in shared
// memory; below 0, so no CUDA error has this value
#define KMS_ERR_TABLE (-1)

extern "C" {
// the largest point width the kernel takes, and the code above (read by the
// wrapper)
int kms_max_d = KMS_MAX_D;
int kms_err_table = KMS_ERR_TABLE;
}

// DMAX: the point width rounded up to the next instantiated size, so that a
// point's values live in registers; SMEM: per-block shared accumulators.
template <int DMAX, bool SMEM>
__global__ void __launch_bounds__(KMS_TPB)
kms_main(const float* __restrict__ x, const float* __restrict__ c, long long n, int d, int k,
         float* __restrict__ sums, int* __restrict__ counts) {
  extern __shared__ float smem[];
  float* cs = smem;               // k·d centroids
  float* c2 = cs + k * d;         // k squared norms
  float* sacc = c2 + k;           // k·d sums (SMEM only)
  int* scnt = reinterpret_cast<int*>(sacc + k * d);  // k counts (SMEM only)
  for (int t = threadIdx.x; t < k * d; t += blockDim.x) {
    cs[t] = c[t];
    if (SMEM) sacc[t] = 0.f;
  }
  if (SMEM)
    for (int j = threadIdx.x; j < k; j += blockDim.x) scnt[j] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < d; ++t) s = __fadd_rn(s, __fmul_rn(cs[j * d + t], cs[j * d + t]));
    c2[j] = s;
  }
  __syncthreads();
  float* tacc = SMEM ? sacc : sums;
  int* tcnt = SMEM ? scnt : counts;
  const long long stride = static_cast<long long>(gridDim.x) * KMS_TPB;
  for (long long i = blockIdx.x * static_cast<long long>(KMS_TPB) + threadIdx.x; i < n;
       i += stride) {
    const float* xi = x + i * d;
    float xv[DMAX];
    float x2 = 0.f;
#pragma unroll
    for (int t = 0; t < DMAX; ++t) {
      xv[t] = t < d ? __ldg(xi + t) : 0.f;
      if (t < d) x2 = __fadd_rn(x2, __fmul_rn(xv[t], xv[t]));
    }
    int best = 0;
    float best_d2 = 0.f;
    for (int j = 0; j < k; ++j) {
      const float* cj = cs + j * d;
      float xc = 0.f;
#pragma unroll
      for (int t = 0; t < DMAX; ++t)
        if (t < d) xc = __fadd_rn(xc, __fmul_rn(xv[t], cj[t]));
      const float d2 = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, xc)), c2[j]);
      if (j == 0 || d2 < best_d2) {
        best = j;
        best_d2 = d2;
      }
    }
    atomicAdd(tcnt + best, 1);
    float* acc = tacc + best * d;
#pragma unroll
    for (int t = 0; t < DMAX; ++t)
      if (t < d) atomicAdd(acc + t, xv[t]);
  }
  if (SMEM) {
    __syncthreads();
    for (int t = threadIdx.x; t < k * d; t += blockDim.x)
      if (scnt[t / d] != 0) atomicAdd(sums + t, sacc[t]);
    for (int j = threadIdx.x; j < k; j += blockDim.x)
      if (scnt[j] != 0) atomicAdd(counts + j, scnt[j]);
  }
}

template <int DMAX, bool SMEM>
static cudaError_t kms_run(const float* x, const float* c, long long n, int d, int k,
                           float* sums, int* counts, size_t bytes, int grid, cudaStream_t s) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kms_main<DMAX, SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  kms_main<DMAX, SMEM><<<grid, KMS_TPB, bytes, s>>>(x, c, n, d, k, sums, counts);
  return cudaGetLastError();
}

template <int DMAX>
static cudaError_t kms_pick(bool smem, const float* x, const float* c, long long n, int d, int k,
                            float* sums, int* counts, size_t bytes, int grid, cudaStream_t s) {
  return smem ? kms_run<DMAX, true>(x, c, n, d, k, sums, counts, bytes, grid, s)
              : kms_run<DMAX, false>(x, c, n, d, k, sums, counts, bytes, grid, s);
}

// x (n, d) and c (k, d) f32, row-major and contiguous; sums (k, d) f32 and
// counts (k,) int32 are written (zeroed here first).  Returns KMS_ERR_TABLE
// when the centroids alone do not fit in the opt-in shared memory,
// cudaErrorInvalidValue for a shape the kernel does not take, else the first
// CUDA error it meets (memsets, shared-memory attribute, launch).
extern "C" int kms_launch(const float* x, const float* c, long long n, int d, int k,
                          float* sums, int* counts, void* stream) {
  if (n < 0 || d < 1 || d > KMS_MAX_D || k < 1) return cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t table = sizeof(float) * static_cast<size_t>(k) * (d + 1);
  if (table > static_cast<size_t>(optin)) return KMS_ERR_TABLE;
  const bool smem = 2 * table <= static_cast<size_t>(optin);
  const size_t bytes = smem ? 2 * table : table;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(sums, 0, sizeof(float) * static_cast<size_t>(k) * d, s);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(k), s);
  if (e != cudaSuccess || n == 0) return e;
  const long long need = (n + KMS_TPB - 1) / KMS_TPB;
  const long long most = static_cast<long long>(sms) * KMS_BLOCKS_PER_SM;
  const int grid = static_cast<int>(need < most ? need : most);
  if (d <= 4) return kms_pick<4>(smem, x, c, n, d, k, sums, counts, bytes, grid, s);
  if (d <= 8) return kms_pick<8>(smem, x, c, n, d, k, sums, counts, bytes, grid, s);
  if (d <= 16) return kms_pick<16>(smem, x, c, n, d, k, sums, counts, bytes, grid, s);
  if (d <= 32) return kms_pick<32>(smem, x, c, n, d, k, sums, counts, bytes, grid, s);
  if (d <= 64) return kms_pick<64>(smem, x, c, n, d, k, sums, counts, bytes, grid, s);
  return kms_pick<128>(smem, x, c, n, d, k, sums, counts, bytes, grid, s);
}
