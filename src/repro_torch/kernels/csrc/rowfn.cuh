// rowfn.cuh: the operations of the row functions that
// repro_torch/kernels/codegen.py generates for a query (its predicate, its
// aggregated values, its bucket id), as macros with two meanings.
//
// In device code they are the intrinsics the expression VM used
// (exprvm.cuh): float arithmetic by the _rn intrinsics, which nvcc never
// contracts into an FMA, so every value rounds once per operation, as in
// the interpreter and the plain version; column loads through the
// read-only cache.  Under a host C++ compiler (built with
// -ffp-contract=off) they are plain IEEE single-precision operations and
// plain loads, which round the same way, so a CPU test can build the
// generated functions and hold them bit for bit against
// exprcode.interpret.
//
// Integer add, subtract, multiply and negate wrap, as the VM's 32-bit
// words do; a bool is a 0/1 uint32_t.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define RF_FN __host__ __device__ __forceinline__
#else
#define RF_FN static inline
#endif

#ifdef __CUDA_ARCH__  // nvcc's device pass
#define RF_LDG(p) __ldg(p)
#define RF_FADD(a, b) __fadd_rn((a), (b))
#define RF_FSUB(a, b) __fsub_rn((a), (b))
#define RF_FMUL(a, b) __fmul_rn((a), (b))
#define RF_FDIV(a, b) __fdiv_rn((a), (b))
#define RF_I2F(a) __int2float_rn(a)
#define RF_F32(bits) __uint_as_float(bits)
#define RF_FBITS(x) __float_as_int(x)
#else  // a host compiler, or nvcc's host pass
#include <cmath>
#include <cstring>
#define RF_LDG(p) (*(p))
#define RF_FADD(a, b) ((a) + (b))
#define RF_FSUB(a, b) ((a) - (b))
#define RF_FMUL(a, b) ((a) * (b))
#define RF_FDIV(a, b) ((a) / (b))
#define RF_I2F(a) static_cast<float>(a)
#define RF_F32(bits) rf_f32(bits)
#define RF_FBITS(x) rf_fbits(x)
static inline float rf_f32(uint32_t bits) {
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}
static inline int rf_fbits(float x) {
  int i;
  std::memcpy(&i, &x, sizeof i);
  return i;
}
#endif

#define RF_FMIN(a, b) fminf((a), (b))
#define RF_FMAX(a, b) fmaxf((a), (b))
#define RF_FNEG(a) (-(a))
#define RF_FABS(a) fabsf(a)
#define RF_IADD(a, b) static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b))
#define RF_ISUB(a, b) static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b))
#define RF_IMUL(a, b) static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b))
#define RF_INEG(a) static_cast<int>(0u - static_cast<uint32_t>(a))
#define RF_IABS(a) ((a) < 0 ? RF_INEG(a) : (a))
#define RF_IMIN(a, b) ((a) < (b) ? (a) : (b))
#define RF_IMAX(a, b) ((a) > (b) ? (a) : (b))
#define RF_CMP(a, op, b) static_cast<uint32_t>((a)op(b))

// Finite sentinels for empty min/max (VM_POS / VM_NEG of exprvm.cuh); the
// wrapper maps them back to +-inf.
#define RF_POS 3.0e38f
#define RF_NEG (-3.0e38f)
