// fixsum.cuh: f32 sums whose bits do not depend on the order of their adds,
// for the kernels whose rows reach an accumulator in no fixed order: the
// grouped kernels' smem and global routes (grouped.cuh), seg_main
// (segsum.cu) and kms_main (kmeans_step.cu).  Atomic f32 adds land in
// whatever order the card schedules them, so an f32 atomic sum gives
// other bits from run to run, and a stream micro-batch replayed after a
// recovery other bits than the uninterrupted fold; the JAX package adds
// in one order (jax.ops.segment_sum, the Pallas kernels' one-hot
// products).
//
// Each accumulator (a bucket's value, a segment's column) is an int64 sum
// beside a 32-bit scale word, both zeroed first.  Two passes over the rows:
//
// * scale: each value notes its binary exponent in its accumulator's word
//   by integer atomicMax (the word keeps the largest, E); a non-finite value
//   sets a flag instead by atomicOr (+inf, -inf or NaN);
// * add: each value becomes an integer, its 24-bit significand shifted to
//   the unit u = 2^(E - 150 - F), rounded to nearest (ties away from zero),
//   and is added by int64 atomicAdd.  F = 39 - bitlen(rows), so rows values
//   of magnitude below 2^(E - 126) sum below 2^63: no overflow.
//
// Integer adds do not depend on their order: any grid and any order of the
// atomics give the same int64, and the finish writes it as the nearest f32
// (through f64: exact up to 2^53, then two roundings to nearest, each
// deterministic).  A flagged accumulator finishes as the f32 sum would:
// NaN for a NaN or for +inf beside -inf, else the infinity.  ref.fixed_sum
// is this arithmetic in plain torch, bit for bit.
//
// Accuracy against the f32 sum.  An accumulator of k values is off by at
// most k·u/2 ≤ k·2^(bitlen(rows) - 63)·|v_max| before its f32 rounding,
// |v_max| its largest value (≥ 2^(E - 127)); an f32 sum of the same k
// values, in any order, may be off by (k - 1)·2^-24·Σ|v|, which is more for
// every k ≥ 2 while bitlen(rows) ≤ 38 (Q1 at sf=5, rows ≈ 3.0 million,
// bitlen 22: 2^-41·k·|v_max|).  Values more than F + 24 binades below E
// round to 0; a value's rounding is at most u/2 either way.
#pragma once

#include <cstdint>

#define FIX_FLAG_POS 1u
#define FIX_FLAG_NEG 2u
#define FIX_FLAG_NAN 4u

// F, the bits kept below the largest value's unit, for `rows` values
__host__ __device__ __forceinline__ int fix_frac(long long rows) {
  int len = 0;
  for (unsigned long long r = rows > 0 ? static_cast<unsigned long long>(rows) : 0; r; r >>= 1)
    ++len;
  return 39 - len;
}

// What value v notes in its scale word: 0 for a zero, its biased exponent
// (1 for a subnormal) for a finite value, a flag above 0xFF (with 0xFF
// below it) for an infinity or a NaN.
__device__ __forceinline__ uint32_t fix_word(float v) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t e = (bits >> 23) & 0xFFu;
  if (e == 0xFFu) {
    const uint32_t flag = (bits & 0x7FFFFFu) ? FIX_FLAG_NAN
                                             : ((bits >> 31) ? FIX_FLAG_NEG : FIX_FLAG_POS);
    return (flag << 8) | 0xFFu;
  }
  if ((bits & 0x7FFFFFFFu) == 0) return 0;
  return e ? e : 1u;
}

// Merges a noted word into *w: the largest exponent, the union of the
// flags (a flagged word is above every exponent, so atomicMax keeps it).
__device__ __forceinline__ void fix_merge(uint32_t* w, uint32_t word) {
  if (word > 0xFFu) atomicOr(w, word);
  else if (word) atomicMax(w, word);
}

// v as an integer in units of 2^(E - 150 - F), E the word's exponent; 0
// where the word is flagged (its finish ignores the sum)
__device__ __forceinline__ long long fix_int(float v, uint32_t word, int frac) {
  if (word > 0xFFu || word == 0) return 0;
  const uint32_t bits = __float_as_uint(v);
  const uint32_t ef = (bits >> 23) & 0xFFu;
  if ((bits & 0x7FFFFFFFu) == 0) return 0;
  const long long m = static_cast<long long>((bits & 0x7FFFFFu) | (ef ? 0x800000u : 0u));
  const int shift = static_cast<int>(ef ? ef : 1u) - static_cast<int>(word) + frac;
  long long q;
  if (shift >= 0) q = m << shift;
  else if (shift >= -30) q = (m + (1LL << (-shift - 1))) >> -shift;
  else q = 0;
  return (bits >> 31) ? -q : q;
}

// The f32 of an accumulator: its int64 sum in units of 2^(E - 150 - F), or
// its flags' infinity or NaN.
__device__ __forceinline__ float fix_float(long long sum, uint32_t word, int frac) {
  if (word > 0xFFu) {
    const uint32_t f = word >> 8;
    if ((f & FIX_FLAG_NAN) || (f & (FIX_FLAG_POS | FIX_FLAG_NEG)) == (FIX_FLAG_POS | FIX_FLAG_NEG))
      return __int_as_float(0x7FC00000);
    return (f & FIX_FLAG_POS) ? __int_as_float(0x7F800000) : __int_as_float(0xFF800000);
  }
  if (sum == 0) return 0.f;
  return __double2float_rn(
      ldexp(__ll2double_rn(sum), static_cast<int>(word) - 150 - frac));
}

__device__ __forceinline__ void fix_add(long long* a, long long q) {
  if (q) atomicAdd(reinterpret_cast<unsigned long long*>(a), static_cast<unsigned long long>(q));
}

// ---- segment sums: data (n, d) f32 by id (n,) into (K, d) ---------------------
//
// The shape of seg_main and of kms_main's sums (its labels the ids): one
// thread per element in a grid-stride loop over n·d, so neighbouring
// threads read neighbouring addresses; ids outside [0, K) are dropped.  The
// K·d scale words (pass 1) and int64 sums (pass 2) are kept per block in
// shared memory where they fit (SMEM) and merged into the global ones at
// the block's end, else the elements go to the global ones directly.

template <bool SMEM>
__global__ void __launch_bounds__(256)
fix_seg_scale(const float* __restrict__ data, const int* __restrict__ ids, long long n, int d,
              int K, uint32_t* __restrict__ scale) {
  extern __shared__ uint32_t sw[];
  const long long cells = static_cast<long long>(K) * d;
  if (SMEM) {
    for (long long t = threadIdx.x; t < cells; t += blockDim.x) sw[t] = 0;
    __syncthreads();
  }
  uint32_t* w = SMEM ? sw : scale;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n * d;
       e += stride) {
    const long long row = e / d;
    const int id = __ldg(ids + row);
    if (id < 0 || id >= K) continue;
    fix_merge(w + static_cast<long long>(id) * d + (e - row * d), fix_word(__ldg(data + e)));
  }
  if (SMEM) {
    __syncthreads();
    for (long long t = threadIdx.x; t < cells; t += blockDim.x) fix_merge(scale + t, sw[t]);
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(256)
fix_seg_add(const float* __restrict__ data, const int* __restrict__ ids, long long n, int d,
            int K, const uint32_t* __restrict__ scale, long long* __restrict__ sums) {
  extern __shared__ long long ss[];
  const long long cells = static_cast<long long>(K) * d;
  if (SMEM) {
    for (long long t = threadIdx.x; t < cells; t += blockDim.x) ss[t] = 0;
    __syncthreads();
  }
  long long* a = SMEM ? ss : sums;
  const int frac = fix_frac(n);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n * d;
       e += stride) {
    const long long row = e / d;
    const int id = __ldg(ids + row);
    if (id < 0 || id >= K) continue;
    const long long cell = static_cast<long long>(id) * d + (e - row * d);
    fix_add(a + cell, fix_int(__ldg(data + e), __ldg(scale + cell), frac));
  }
  if (SMEM) {
    __syncthreads();
    for (long long t = threadIdx.x; t < cells; t += blockDim.x) fix_add(sums + t, ss[t]);
  }
}

__global__ void fix_seg_out(const uint32_t* __restrict__ scale, const long long* __restrict__ sums,
                            long long cells, long long n, float* __restrict__ out) {
  const int frac = fix_frac(n);
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < cells;
       t += static_cast<long long>(gridDim.x) * blockDim.x)
    out[t] = fix_float(sums[t], scale[t], frac);
}

// Bytes of scratch fix_seg_sum needs for K·d accumulators: the int64 sums,
// then the scale words.
static inline long long fix_seg_bytes(long long cells) { return cells * 12; }

// out (K, d) = the rows of data summed by id, ids outside [0, K) dropped,
// in the three passes above; `scratch` holds fix_seg_bytes(K·d) bytes of
// anything (zeroed here).  `blocks` runs the two passes over the elements.
static cudaError_t fix_seg_sum(const float* data, const int* ids, long long n, int d, int K,
                               float* out, void* scratch, int blocks, cudaStream_t s) {
  const long long cells = static_cast<long long>(K) * d;
  long long* sums = static_cast<long long*>(scratch);
  uint32_t* scale = reinterpret_cast<uint32_t*>(sums + cells);
  cudaError_t e = cudaMemsetAsync(scratch, 0, static_cast<size_t>(fix_seg_bytes(cells)), s);
  if (e != cudaSuccess) return e;
  if (n > 0) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const size_t words = sizeof(uint32_t) * static_cast<size_t>(cells);
    const size_t wide = sizeof(long long) * static_cast<size_t>(cells);
    if (words <= static_cast<size_t>(optin)) {
      if (words > 48 * 1024) {
        e = cudaFuncSetAttribute(fix_seg_scale<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(words));
        if (e != cudaSuccess) return e;
      }
      fix_seg_scale<true><<<blocks, 256, words, s>>>(data, ids, n, d, K, scale);
    } else {
      fix_seg_scale<false><<<blocks, 256, 0, s>>>(data, ids, n, d, K, scale);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (wide <= static_cast<size_t>(optin)) {
      if (wide > 48 * 1024) {
        e = cudaFuncSetAttribute(fix_seg_add<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(wide));
        if (e != cudaSuccess) return e;
      }
      fix_seg_add<true><<<blocks, 256, wide, s>>>(data, ids, n, d, K, scale, sums);
    } else {
      fix_seg_add<false><<<blocks, 256, 0, s>>>(data, ids, n, d, K, scale, sums);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long g = (cells + 255) / 256;
  fix_seg_out<<<static_cast<int>(g < 4096 ? g : 4096), 256, 0, s>>>(scale, sums, cells, n, out);
  return cudaGetLastError();
}
