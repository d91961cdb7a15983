// flash_attention: causal / sliding-window GQA attention, forward only, with
// an online softmax.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_p.  That
// kernel walks a sequential grid (batch, q head, q block, kv block) on one
// TPU core and carries m, l and acc in VMEM scratch from one kv block to the
// next; its K/V blocks are fetched once per q head.  Here the kv walk is a
// loop inside the thread block, and one block serves every query head of a
// kv head (the GQA group, 6 for Qwen2-1.5B), so each K/V tile is read from
// device memory once per group instead of once per head.
//
// Bound on the card: operations.  At the served shape (q 4×12×2048×128,
// k/v 4×2×2048×128, bf16, causal) the causal half of 4·B·Hq·S²·D is about
// 51.5 GFLOP against 31 MB of inputs and output: 0.77 ms at the 67 TFLOP/s
// of f32 outside the tensor cores, 0.009 ms of memory traffic.  This first
// design uses no tensor cores (no mma, wgmma or TMA), so 67 TFLOP/s is its
// ceiling; the redesign aims at the bf16 tensor-core rate.
//
// Design.  Block (q tile, b·Hkv + kv head); a q tile is BQ positions of all
// `group` heads, BQ = 64 / group rounded down (at least 1), so a block has
// up to 64 query rows.  Four threads share a row: thread `part` owns the
// float4 slices 16i + 4·part of q·scale (f32, in registers) and of the f32
// accumulator, so a row costs D/2 registers per thread and a warp's reads of
// one K or V row hit four distinct 16-byte words in distinct banks.  K and V
// tiles of 64 positions are converted to f32 on load into dynamic shared
// memory (2·64·D·4 bytes: 64 KB at D = 128, above the 48 KB default).  Per
// chunk of 16 kv positions a thread forms its partial dots, the quad adds
// them with two xor-shuffles, masked logits become the −1e30 sentinel, and
// the online update runs once per chunk: m_new = max(m, chunk max),
// α = exp(m − m_new), p = exp(s − m_new) (0 where masked), l = l·α + Σp,
// acc = acc·α + Σ p·v.  The output is acc / l with l = 0 → 1, so a row with
// nothing unmasked gives 0.  Tiles wholly above the diagonal of the block's
// last row (causal), or wholly left of the window of its first row, are not
// loaded; the rest are masked per element with the inequalities of the
// Pallas body (kpos ≤ qpos; kpos > qpos − window).  S need not be a
// multiple of any tile: positions past S are masked and rows past S are not
// written.  Products are explicit fmaf (the shared build flags disable
// contraction).  The q tiles run latest first, since causal work grows with
// the position.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FA_BK 64       // kv positions per shared-memory tile
#define FA_CHUNK 16    // kv positions per online-softmax update
#define FA_ROWS 64     // query rows (heads × positions) per block, at most
#define FA_MAX_GROUP 64
#define FA_NEG (-1.0e30f)

extern "C" {
// the largest Hq / Hkv the kernel takes (read by the wrapper)
int fa_max_group = FA_MAX_GROUP;
}

__device__ __forceinline__ float4 fa_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 fa_load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void fa_store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void fa_store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float fa_dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(4 * FA_ROWS, 2)
fa_main(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
        T* __restrict__ o, int hq, int hkv, int s, int group, int bq, int causal, int window,
        float scale) {
  constexpr int NV = D / 16;  // float4 slices per thread
  extern __shared__ float4 fa_smem[];
  float* ks = reinterpret_cast<float*>(fa_smem);  // FA_BK × D
  float* vs = ks + FA_BK * D;                     // FA_BK × D

  const int part = threadIdx.x & 3;
  const int row = threadIdx.x >> 2;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int b = blockIdx.y / hkv, kh = blockIdx.y % hkv;
  const int gi = row / bq;
  const int qpos = q0 + row % bq;
  const bool live = gi < group && qpos < s;  // padding rows compute and store nothing
  const long long qoff =
      ((static_cast<long long>(b) * hq + kh * group + (live ? gi : 0)) * s + (live ? qpos : 0)) *
      D;

  float4 qf[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 x = live ? fa_load4(q + qoff + 16 * i + 4 * part) : make_float4(0.f, 0.f, 0.f, 0.f);
    qf[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = FA_NEG, l = 0.f;

  // the kv positions any row of this block attends to: [lo, hi)
  const int qlast = min(q0 + bq, s) - 1;
  const int hi = causal ? qlast + 1 : s;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const long long kvoff = (static_cast<long long>(b) * hkv + kh) * s * D;

  for (int t0 = (lo / FA_BK) * FA_BK; t0 < hi; t0 += FA_BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < FA_BK * D / 4; e += blockDim.x) {
      const int j = e / (D / 4), c = (e % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (t0 + j < s) {
        const long long g = kvoff + static_cast<long long>(t0 + j) * D + c;
        kx = fa_load4(k + g);
        vx = fa_load4(v + g);
      }
      fa_store4(ks + j * D + c, kx);
      fa_store4(vs + j * D + c, vx);
    }
    __syncthreads();
    const int jn = min(FA_BK, hi - t0);
    for (int j0 = 0; j0 < jn; j0 += FA_CHUNK) {
      float sc[FA_CHUNK];
      unsigned ok = 0;
      float cmax = FA_NEG;
#pragma unroll
      for (int j = 0; j < FA_CHUNK; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + j) * D) + part;
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) x = fa_dot4(qf[i], kr[4 * i], x);
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const int kp = t0 + j0 + j;
        const bool keep = kp < s && (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
        sc[j] = keep ? x : FA_NEG;
        ok |= keep ? (1u << j) : 0u;
        cmax = fmaxf(cmax, sc[j]);
      }
      const float mn = fmaxf(m, cmax);
      const float alpha = expf(m - mn);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < FA_CHUNK; ++j) {
        sc[j] = ((ok >> j) & 1u) ? expf(sc[j] - mn) : 0.f;
        psum += sc[j];
      }
      l = fmaf(l, alpha, psum);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < FA_CHUNK; ++j) {
        const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + j) * D) + part;
        const float p = sc[j];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 w = vr[4 * i];
          acc[i].x = fmaf(p, w.x, acc[i].x);
          acc[i].y = fmaf(p, w.y, acc[i].y);
          acc[i].z = fmaf(p, w.z, acc[i].z);
          acc[i].w = fmaf(p, w.w, acc[i].w);
        }
      }
      m = mn;
    }
  }
  if (live) {
    const float den = l == 0.f ? 1.f : l;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      fa_store4(o + qoff + 16 * i + 4 * part,
                make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den, acc[i].w / den));
  }
}

template <typename T, int D>
static cudaError_t fa_run(const void* q, const void* k, const void* v, void* o, int hq, int hkv,
                          int s, int group, int bq, int causal, int window, float scale,
                          dim3 grid, int threads, cudaStream_t st) {
  const size_t bytes = 2 * sizeof(float) * FA_BK * D;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_main<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  fa_main<T, D><<<grid, threads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, s, group, bq, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t fa_width(int d, const void* q, const void* k, const void* v, void* o, int hq,
                            int hkv, int s, int group, int bq, int causal, int window,
                            float scale, dim3 grid, int threads, cudaStream_t st) {
  if (d == 32)
    return fa_run<T, 32>(q, k, v, o, hq, hkv, s, group, bq, causal, window, scale, grid, threads, st);
  if (d == 64)
    return fa_run<T, 64>(q, k, v, o, hq, hkv, s, group, bq, causal, window, scale, grid, threads, st);
  return fa_run<T, 128>(q, k, v, o, hq, hkv, s, group, bq, causal, window, scale, grid, threads, st);
}

// q (b, hq, s, d) and k, v (b, hkv, s, d), contiguous, f32 (bf16 = 0) or
// bf16 (bf16 = 1), 16-byte aligned; o (b, hq, s, d) of q's type is written.
// window ≤ 0 means no window; scale multiplies q before the products.
// Returns cudaErrorInvalidValue for a shape the kernel does not take, else
// the first CUDA error it meets (shared-memory attribute, launch).
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
                         int hkv, int s, int d, int bf16, int causal, int window, float scale,
                         void* stream) {
  if (b < 0 || hkv < 1 || hq < hkv || hq % hkv != 0 || s < 1 || (d != 32 && d != 64 && d != 128))
    return cudaErrorInvalidValue;
  const int group = hq / hkv;
  if (group > FA_MAX_GROUP || static_cast<long long>(b) * hkv > 65535) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const int bq = group >= FA_ROWS ? 1 : FA_ROWS / group;
  const int nq = (s + bq - 1) / bq;
  const int rows = (group * bq + 7) / 8 * 8;  // whole warps: a quad's shuffles need all 32 lanes
  const dim3 grid(nq, b * hkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fa_width<__nv_bfloat16>(d, q, k, v, o, hq, hkv, s, group, bq, causal, window, scale,
                                   grid, 4 * rows, st);
  return fa_width<float>(d, q, k, v, o, hq, hkv, s, group, bq, causal, window, scale, grid,
                         4 * rows, st);
}
