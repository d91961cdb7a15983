// Shared pieces of the relational kernels: the expression VM, key packing
// and float atomics.
//
// The Pallas kernels of the JAX package close over the query's Expr and
// compile one kernel per query.  Here one nvcc build serves every query:
// the wrapper lowers each Expr to a small typed postfix program
// (repro_torch/kernels/exprcode.py) that every thread interprets.  All
// threads read the same instruction at the same time, so the reads are
// uniform and the dispatch does not diverge.
//
// Values on the stack are 32-bit words: int32, float32 bits, or 0/1 for a
// bool.  Types were fixed when the program was built, so the VM never
// checks them.  Float arithmetic uses the _rn intrinsics, which nvcc never
// contracts into an FMA, so each value rounds as in the plain version.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define VM_MAX_COLS 32
#define VM_MAX_STACK 16
#define VM_MAX_ACC 16
#define VM_MAX_OUT (1 + VM_MAX_ACC)
#define VM_MAX_KEYS 8
#define VM_TPB 256

// Kept in step with OPCODES in exprcode.py (a CPU test compares them).
enum VmOp {
  OP_LOAD_I32 = 1,
  OP_LOAD_F32 = 2,
  OP_LOAD_U8 = 3,
  OP_CONST = 4,
  OP_ADD_I = 5,
  OP_SUB_I = 6,
  OP_MUL_I = 7,
  OP_MIN_I = 8,
  OP_MAX_I = 9,
  OP_NEG_I = 10,
  OP_ABS_I = 11,
  OP_ADD_F = 12,
  OP_SUB_F = 13,
  OP_MUL_F = 14,
  OP_DIV_F = 15,
  OP_MIN_F = 16,
  OP_MAX_F = 17,
  OP_NEG_F = 18,
  OP_ABS_F = 19,
  OP_LT_I = 20,
  OP_LE_I = 21,
  OP_GT_I = 22,
  OP_GE_I = 23,
  OP_EQ_I = 24,
  OP_NE_I = 25,
  OP_LT_F = 26,
  OP_LE_F = 27,
  OP_GT_F = 28,
  OP_GE_F = 29,
  OP_EQ_F = 30,
  OP_NE_F = 31,
  OP_AND = 32,
  OP_OR = 33,
  OP_NOT = 34,
  OP_I2F = 35,
  OP_EMIT = 36,
};

enum VmColType { COL_I32 = 0, COL_F32 = 1, COL_U8 = 2 };
enum VmAccFn { ACC_SUM = 0, ACC_MIN = 1, ACC_MAX = 2 };

// Finite sentinels for empty min/max, as the Pallas kernels use; the
// wrapper maps them back to +-inf.
#define VM_POS 3.0e38f
#define VM_NEG (-3.0e38f)

struct VmCols {
  const void* ptr[VM_MAX_COLS];
  int type[VM_MAX_COLS];
  int src[VM_MAX_COLS];  // 0: indexed by the probe row, 1: by the join bucket
};

struct VmKeys {
  int n;
  int slot[VM_MAX_KEYS];
  long long lo[VM_MAX_KEYS];
  long long size[VM_MAX_KEYS];
};

struct VmAccs {
  int n;
  int fn[VM_MAX_ACC];
};

static inline VmCols vm_make_cols(const void* const* ptrs, const int* types,
                                  const int* src, int n) {
  VmCols c = {};
  for (int j = 0; j < n; ++j) {
    c.ptr[j] = ptrs[j];
    c.type[j] = types[j];
    c.src[j] = src[j];
  }
  return c;
}

static inline VmKeys vm_make_keys(const int* slot, const long long* lo,
                                  const long long* size, int n) {
  VmKeys k = {};
  k.n = n;
  for (int j = 0; j < n; ++j) {
    k.slot[j] = slot[j];
    k.lo[j] = lo[j];
    k.size[j] = size[j];
  }
  return k;
}

static inline VmAccs vm_make_accs(const int* fns, int n) {
  VmAccs a = {};
  a.n = n;
  for (int j = 0; j < n; ++j) a.fn[j] = fns[j];
  return a;
}

// Blocks of a grid-stride pass over `rows` rows: one row per thread, at
// most `per_sm` blocks on each SM of the current device.
static inline int vm_grid(long long rows, int per_sm) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (rows + VM_TPB - 1) / VM_TPB;
  const long long most = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(need < 1 ? 1 : (need < most ? need : most));
}

__device__ __forceinline__ long long vm_index(const VmCols& c, int j,
                                              long long i0, long long i1) {
  return c.src[j] ? i1 : i0;
}

__device__ __forceinline__ uint32_t vm_load4(const VmCols& c, int j,
                                             long long i0, long long i1) {
  return __ldg(static_cast<const uint32_t*>(c.ptr[j]) + vm_index(c, j, i0, i1));
}

__device__ __forceinline__ uint32_t vm_load1(const VmCols& c, int j,
                                             long long i0, long long i1) {
  return __ldg(static_cast<const uint8_t*>(c.ptr[j]) + vm_index(c, j, i0, i1));
}

// Runs prog[begin, end); EMIT k pops the top of the stack into out[k].
__device__ __forceinline__ void vm_run(const int2* __restrict__ prog, int begin,
                                       int end, const VmCols& c, long long i0,
                                       long long i1, uint32_t* out) {
  uint32_t st[VM_MAX_STACK];
  int sp = 0;
  for (int pc = begin; pc < end; ++pc) {
    const int2 ins = __ldg(prog + pc);
    const int arg = ins.y;
    if (ins.x <= OP_CONST) {
      if (ins.x == OP_LOAD_U8) st[sp++] = vm_load1(c, arg, i0, i1);
      else if (ins.x == OP_CONST) st[sp++] = static_cast<uint32_t>(arg);
      else st[sp++] = vm_load4(c, arg, i0, i1);
      continue;
    }
    if (ins.x == OP_EMIT) {
      out[arg] = st[--sp];
      continue;
    }
    // unary ops work on the top in place
    const uint32_t ub = st[sp - 1];
    const float fb = __uint_as_float(ub);
    const int ib = static_cast<int>(ub);
    switch (ins.x) {
      case OP_NEG_I: st[sp - 1] = 0u - ub; continue;
      case OP_ABS_I: st[sp - 1] = ib < 0 ? 0u - ub : ub; continue;
      case OP_NEG_F: st[sp - 1] = __float_as_uint(-fb); continue;
      case OP_ABS_F: st[sp - 1] = __float_as_uint(fabsf(fb)); continue;
      case OP_NOT: st[sp - 1] = 1u - ub; continue;
      case OP_I2F: st[sp - 1] = __float_as_uint(__int2float_rn(ib)); continue;
      default: break;
    }
    // binary ops: a = second from top, b = top
    --sp;
    const uint32_t ua = st[sp - 1];
    const float fa = __uint_as_float(ua);
    const int ia = static_cast<int>(ua);
    uint32_t r = 0;
    switch (ins.x) {
      case OP_ADD_I: r = ua + ub; break;
      case OP_SUB_I: r = ua - ub; break;
      case OP_MUL_I: r = ua * ub; break;
      case OP_MIN_I: r = static_cast<uint32_t>(ia < ib ? ia : ib); break;
      case OP_MAX_I: r = static_cast<uint32_t>(ia > ib ? ia : ib); break;
      case OP_ADD_F: r = __float_as_uint(__fadd_rn(fa, fb)); break;
      case OP_SUB_F: r = __float_as_uint(__fsub_rn(fa, fb)); break;
      case OP_MUL_F: r = __float_as_uint(__fmul_rn(fa, fb)); break;
      case OP_DIV_F: r = __float_as_uint(__fdiv_rn(fa, fb)); break;
      case OP_MIN_F: r = __float_as_uint(fminf(fa, fb)); break;
      case OP_MAX_F: r = __float_as_uint(fmaxf(fa, fb)); break;
      case OP_LT_I: r = ia < ib; break;
      case OP_LE_I: r = ia <= ib; break;
      case OP_GT_I: r = ia > ib; break;
      case OP_GE_I: r = ia >= ib; break;
      case OP_EQ_I: r = ia == ib; break;
      case OP_NE_I: r = ia != ib; break;
      case OP_LT_F: r = fa < fb; break;
      case OP_LE_F: r = fa <= fb; break;
      case OP_GT_F: r = fa > fb; break;
      case OP_GE_F: r = fa >= fb; break;
      case OP_EQ_F: r = fa == fb; break;
      case OP_NE_F: r = fa != fb; break;
      case OP_AND: r = ua & ub; break;
      case OP_OR: r = ua | ub; break;
      default: break;
    }
    st[sp - 1] = r;
  }
}

// A key column as an integer: 32-bit columns by their bits (f32 keys are
// bit-cast, as the JAX runtime's _int_key does), bool columns as 0/1.
__device__ __forceinline__ long long vm_key(const VmCols& c, int j, long long i0,
                                            long long i1) {
  if (c.type[j] == COL_U8) return static_cast<long long>(vm_load1(c, j, i0, i1));
  return static_cast<long long>(static_cast<int>(vm_load4(c, j, i0, i1)));
}

// Dense bucket id: lexicographic rank in the static key domains.  With
// `checked`, a key outside its domain clears `ok` (a join must not let it
// alias the boundary bucket); grouping clips, as bucket_ids does.
__device__ __forceinline__ long long vm_bucket(const VmKeys& k, const VmCols& c,
                                               long long i0, long long i1,
                                               bool* ok) {
  long long b = 0;
  for (int j = 0; j < k.n; ++j) {
    long long v = vm_key(c, k.slot[j], i0, i1) - k.lo[j];
    if (v < 0 || v >= k.size[j]) *ok = false;
    v = v < 0 ? 0 : (v >= k.size[j] ? k.size[j] - 1 : v);
    b = b * k.size[j] + v;
  }
  return b;
}

__device__ __forceinline__ float vm_identity(int fn) {
  return fn == ACC_MIN ? VM_POS : (fn == ACC_MAX ? VM_NEG : 0.0f);
}

__device__ __forceinline__ float vm_combine(int fn, float a, float b) {
  return fn == ACC_MIN ? fminf(a, b) : (fn == ACC_MAX ? fmaxf(a, b) : a + b);
}

// Float min/max by integer atomics: a non-negative float orders like its
// int bits, a negative one in reverse order of its unsigned bits.
__device__ __forceinline__ void vm_atomic_min(float* a, float v) {
  if (!signbit(v)) atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMax(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

__device__ __forceinline__ void vm_atomic_max(float* a, float v) {
  if (!signbit(v)) atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

__device__ __forceinline__ void vm_atomic(int fn, float* a, float v) {
  if (fn == ACC_SUM) atomicAdd(a, v);
  else if (fn == ACC_MIN) vm_atomic_min(a, v);
  else vm_atomic_max(a, v);
}

// Fills the global accumulators: counts 0, each value row its identity.
__global__ void vm_init_accumulators(int* __restrict__ cnt, float* __restrict__ acc,
                                     long long nb, VmAccs accs) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       b < nb; b += stride) {
    cnt[b] = 0;
    for (int k = 0; k < accs.n; ++k) acc[k * nb + b] = vm_identity(accs.fn[k]);
  }
}

// Shared-memory privatisation: counts and accumulators of every bucket in
// one block, when they fit in this many bytes (no opt-in attribute needed).
#define VM_SMEM_BYTES (48 * 1024)

// Bytes of one block's shared accumulators over nb buckets, or 0 when they
// do not fit and rows add into the global accumulators instead.
static inline long long vm_smem_bytes(long long nb, int n_acc) {
  const long long bytes = nb * (1 + n_acc) * 4;
  return bytes <= VM_SMEM_BYTES ? bytes : 0;
}

// Blocks per SM of the grouped kernels: few with shared accumulators, so
// that each block folds many rows before its flush; many with global ones.
#define VM_SMEM_BLOCKS_PER_SM 4
#define VM_GLOBAL_BLOCKS_PER_SM 32

// Flushes a block's shared accumulators into the global ones; buckets this
// block never touched are skipped.
__device__ __forceinline__ void vm_flush(const int* scnt, const float* sacc, int* cnt,
                                         float* acc, long long nb, const VmAccs& accs) {
  for (long long b = threadIdx.x; b < nb; b += blockDim.x) {
    const int n = scnt[b];
    if (n == 0) continue;
    atomicAdd(cnt + b, n);
    for (int k = 0; k < accs.n; ++k) vm_atomic(accs.fn[k], acc + k * nb + b, sacc[k * nb + b]);
  }
}

__device__ __forceinline__ void vm_init_shared(int* scnt, float* sacc, long long nb,
                                               const VmAccs& accs) {
  for (long long b = threadIdx.x; b < nb; b += blockDim.x) {
    scnt[b] = 0;
    for (int k = 0; k < accs.n; ++k) sacc[k * nb + b] = vm_identity(accs.fn[k]);
  }
}
