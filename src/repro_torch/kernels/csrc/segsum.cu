// segsum: the rows of data (n, d) f32 summed by segment id (n,) int32 into
// (K, d) f32; ids outside [0, K) are dropped.
//
// Replaces src/repro/kernels/segsum.py:segsum_p.  The TPU has no cheap
// scatter, so that kernel built a (rows, K) one-hot per row block and ran
// one_hotᵀ·data on the matrix unit; its wrapper padded the rows to the block
// size and sent the padding to an extra dump segment.  Hopper scatters with
// atomics instead, and the grid-stride loop stops at n, so there is no
// padding; the dump segment's rule stays: only ids in range count.
//
// Bound on the card: memory.  data and the ids are read once, n·(d+1)·4
// bytes (the k-means SegSum of one chunk, n = 2^21 and d = 8: 75 MB, about
// 23 us at 3.35 TB/s), and K·d sums are written.  One add per element is far
// below the card's rate; contention of the atomics on K·d addresses is the
// likely limit.
//
// Design: one thread per element of data, (row, column), in a grid-stride
// loop over n·d, so neighbouring threads read neighbouring addresses; the d
// threads of a row share its id through the cache.  Each block keeps K·d
// shared accumulators (dynamic shared memory up to the opt-in limit, 227 KB
// on sm_90), adds into them with shared atomics, and flushes its non-zero
// entries once with global atomics; past that limit elements add into the
// global sums directly.  Sums are added in an order that changes from run to
// run.
#include <cuda_runtime.h>

#define SEG_TPB 256
#define SEG_BLOCKS_PER_SM 4

template <bool SMEM>
__global__ void __launch_bounds__(SEG_TPB)
seg_main(const float* __restrict__ data, const int* __restrict__ ids, long long n, int d, int K,
         float* __restrict__ out) {
  extern __shared__ float sacc[];
  const long long cells = static_cast<long long>(K) * d;
  if (SMEM) {
    for (long long t = threadIdx.x; t < cells; t += blockDim.x) sacc[t] = 0.f;
    __syncthreads();
  }
  float* acc = SMEM ? sacc : out;
  const long long total = n * d;
  const long long stride = static_cast<long long>(gridDim.x) * SEG_TPB;
  for (long long e = blockIdx.x * static_cast<long long>(SEG_TPB) + threadIdx.x; e < total;
       e += stride) {
    const long long row = e / d;
    const int id = __ldg(ids + row);
    if (id < 0 || id >= K) continue;
    atomicAdd(acc + static_cast<long long>(id) * d + (e - row * d), __ldg(data + e));
  }
  if (SMEM) {
    __syncthreads();
    for (long long t = threadIdx.x; t < cells; t += blockDim.x) {
      const float v = sacc[t];
      if (v != 0.f) atomicAdd(out + t, v);
    }
  }
}

// data (n, d) f32 and ids (n,) int32, contiguous; out (K, d) f32 is written
// (zeroed here first).  Returns cudaGetLastError() after the launch.
extern "C" int seg_launch(const float* data, const int* ids, long long n, int d, int K,
                          float* out, void* stream) {
  if (n < 0 || d < 1 || K < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(float) * static_cast<size_t>(K) * d;
  cudaError_t e = cudaMemsetAsync(out, 0, bytes, s);
  if (e != cudaSuccess || n == 0) return e;
  int dev = 0, optin = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (n * d + SEG_TPB - 1) / SEG_TPB;
  const long long most = static_cast<long long>(sms) * SEG_BLOCKS_PER_SM;
  const int grid = static_cast<int>(need < most ? need : most);
  if (bytes <= static_cast<size_t>(optin)) {
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(seg_main<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
      if (e != cudaSuccess) return e;
    }
    seg_main<true><<<grid, SEG_TPB, bytes, s>>>(data, ids, n, d, K, out);
  } else {
    seg_main<false><<<grid, SEG_TPB, 0, s>>>(data, ids, n, d, K, out);
  }
  return cudaGetLastError();
}
