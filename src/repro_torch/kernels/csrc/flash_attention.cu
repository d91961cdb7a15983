// flash_attention: causal / sliding-window GQA attention, forward only, with
// an online softmax.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_p.  That
// kernel walks a sequential grid (batch, q head, q block, kv block) on one
// TPU core and carries m, l and acc in VMEM scratch from one kv block to the
// next.  Here the kv walk is a loop inside the thread block, with m, l and
// acc in registers.  Two kernels, chosen by the inputs' type:
//
// bf16 (every served call): `fa_wgmma`, on the tensor cores, D ∈ {32, 64, 112, 128}.
//   Bound on the card: operations.  At the served shape (q 4×12×2048×128,
//   k/v 4×2×2048×128, causal) the unmasked half of 4·B·Hq·S²·D is 51.6
//   GFLOP against 59 MB of inputs and output: 0.052 ms at the 989 TFLOP/s
//   of dense bf16 on the tensor cores, 0.018 ms of memory traffic.
//   Only wgmma reaches that rate, so the design is built around it.
//   - One block per (128-row q tile, q head, batch): two consumer
//     warpgroups of 64 rows each and one producer warpgroup, which gives
//     its registers to the consumers (setmaxnreg: 24 and 240 a thread), so
//     the accumulators of D = 128 do not spill.  The q tiles with the most
//     causal work launch first.  GQA heads are not packed into a block: a
//     (batch, kv head)'s K and V are re-read from the 50 MB L2.
//   - One producer thread loads Q once, then K and V tiles of 128
//     positions by TMA (`cp.async.bulk.tensor`) through a ring of three
//     stages (224 KB with Q at D = 128), each completed on an mbarrier and
//     released by the consumers on another.  TMA writes the 128-byte
//     (64-byte at D = 32) swizzle that the wgmma descriptors name, and
//     fills rows past S with zeros, so any S ≥ 1 takes the same path.
//     Tiles wholly above the diagonal or left of the window are never
//     loaded.
//   - The softmax's arithmetic runs beside the tensor cores: a warpgroup
//     starts tile i's Q·Kᵀ and tile i − 1's P·V together and does tile i's
//     softmax while P·V runs; and the two warpgroups take turns to start
//     their products (named barriers), so one's products run while the
//     other's softmax does.
//   - S = Q·Kᵀ is `wgmma.m64n128k16` with both operands in shared memory
//     (K-major); the scale (times log2 e) multiplies the f32 logits, so q
//     is never rounded again.  Masking (kpos ≤ qpos; kpos > qpos − window;
//     kpos < S) runs element by element only on tiles that cross an edge;
//     a masked logit is −inf while m starts at the −1e30 sentinel, so a
//     masked weight is exactly 0 and no row gives NaN.
//   - The online softmax stays in the accumulator's registers: a row's max
//     is reduced over the 4 threads that hold it with two xor-shuffles, l
//     is kept per thread and reduced once at the end, the m/l/α update is
//     written with explicit fmaf (the shared flags disable contraction),
//     and acc is not rescaled where α is 1 for every row of a warp.
//   - O += P·V is `wgmma.m64n{D}k16` with P rounded to bf16 in registers as
//     the A operand (the f32 accumulator's fragment of 16 columns is the
//     bf16 A fragment, element for element) and V from shared memory,
//     MN-major (the transpose bit).  l sums the f32 weights.
//   - The output is acc / l with l = 0 → 1, so a row with nothing unmasked
//     gives 0; rows past S are not written.
//   - D = 112 (Zamba2-7B's shared attention) runs in the D = 128 tile,
//     zero-filled.  The tensor maps say the rows are 112 wide with a
//     224-byte stride (a multiple of 16, as cuTensorMapEncodeTiled needs);
//     the second 64-column box of a row then reaches past the global width,
//     and TMA fills its columns 112–127 with zeros and still counts the
//     whole box's bytes on the mbarrier.  Q·Kᵀ takes 7 k16 steps (columns
//     0–111, exact); P·V runs at n = 128, its last 16 columns adding
//     P·0 = 0, and the epilogue stores 112 columns.  Chosen over a native
//     m64n112 P·V because 224-byte rows do not split into 128-byte swizzled
//     boxes: the tile would need a box and swizzle layout of its own, while
//     this costs 1/7 more P·V work on the tensor cores and nothing else.
//     The wrapper passes the scale 1/√112.
//
// f32: `fa_main`, on the CUDA cores (tensor cores in TF32 would not give
//   its rtol 1e-4), D ∈ {32, 64, 112, 128} (at 112 a thread owns 7 float4
//   slices and a row is 448 bytes, 16-byte aligned).  Block (q tile,
//   b·Hkv + kv head); a q tile is BQ positions of all `group` heads, BQ = 64 / group rounded down (at least
//   1), so a block has up to 64 query rows and each K/V tile is read once
//   per group.  Four threads share a row: thread `part` owns the float4
//   slices 16i + 4·part of q·scale and of the accumulator, so a row costs
//   D/2 registers per thread and a warp's reads of one K or V row hit four
//   distinct 16-byte words in distinct banks.  K and V tiles of 64
//   positions sit in dynamic shared memory (64 KB at D = 128).  Per chunk
//   of 16 kv positions a thread forms its partial dots, the quad adds them
//   with two xor-shuffles, masked logits become the −1e30 sentinel, and the
//   online update runs once per chunk: m_new = max(m, chunk max),
//   α = exp(m − m_new), p = exp(s − m_new) (0 where masked),
//   l = l·α + Σp, acc = acc·α + Σ p·v.  Tile skipping, masks, ragged S and
//   the epilogue are as above.  Products are explicit fmaf.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#define FA_BK 64       // fa_main: kv positions per shared-memory tile
#define FA_CHUNK 16    // fa_main: kv positions per online-softmax update
#define FA_ROWS 64     // fa_main: query rows (heads × positions) per block, at most
#define FA_MAX_GROUP 64
#define FA_NEG (-1.0e30f)

#define FA_TBQ 128     // fa_wgmma: query rows per block, 64 per consumer warpgroup
#define FA_TBK 128     // fa_wgmma: kv positions per tile
#define FA_STAGES 3    // fa_wgmma: K/V tiles in flight
#define FA_THREADS 384 // fa_wgmma: two consumer warpgroups and one producer warpgroup
// registers a thread after the producer gives its share to the consumers:
// 128·24 + 256·240 = 384·168, the block's allocation at launch
#define FA_PRODUCER_REGS 24
#define FA_CONSUMER_REGS 240

extern "C" {
// the largest Hq / Hkv the kernels take (read by the wrapper)
int fa_max_group = FA_MAX_GROUP;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// shared-memory geometry of fa_wgmma at head width D; D = 112 runs in the
// D = 128 tile, its columns 112–127 zero-filled by TMA
template <int D>
struct FaTile {
  static constexpr int DT = D == 112 ? 128 : D;           // columns a tile holds
  static constexpr int SWB = DT * 2 < 128 ? DT * 2 : 128; // swizzle span: bytes of a box row
  static constexpr int EPB = SWB / 2;                     // elements of a box row
  static constexpr int NBOX = DT / EPB;                   // boxes across the tile
  static constexpr int KPB = EPB / 16;                    // k16 steps per box
  static constexpr int SWIZZLE = SWB == 128 ? 1 : 2;      // descriptor code: 128 or 64 bytes
  static constexpr int Q_BOX = FA_TBQ * SWB;
  static constexpr int KV_BOX = FA_TBK * SWB;
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;          // one K or V tile
  // Q, the K ring, the V ring, 2·STAGES + 1 barriers, and slack to align to 1024
  static constexpr int SMEM = Q_BYTES + 2 * FA_STAGES * KV_BYTES + 64 + 1024;
};

__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t fa_pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__device__ __forceinline__ void fa_pv(float (&o)[D / 2], const uint32_t (&p)[4], uint64_t v) {
  if constexpr (D == 32)
    hop::wgmma_rs_m64n32(o, p, v, 1);
  else if constexpr (D == 64)
    hop::wgmma_rs_m64n64(o, p, v, 1);
  else
    hop::wgmma_rs_m64n128(o, p, v, 1);
}

// One tile's logits, in place, into softmax weights: the scale (in log2
// units), the mask on a tile that crosses an edge (−inf), the row maxima m0
// (row r0: registers 4j, 4j+1) and m1 (row r0 + 8: 4j+2, 4j+3) raised to
// the tile's, the weights exp2(x − m), and their per-thread sums added to
// l0 and l1 after scaling them by α.  Returns α for the two rows in a0, a1.
__device__ __forceinline__ void fa_softmax(float (&sc)[FA_TBK / 2], bool edge, int kv0, int qp0,
                                           int quad, int s, int causal, int window,
                                           float scale_log2, float& m0, float& m1, float& l0,
                                           float& l1, float& a0, float& a1) {
#pragma unroll
  for (int r = 0; r < FA_TBK / 2; ++r) sc[r] *= scale_log2;
  if (edge) {
#pragma unroll
    for (int r = 0; r < FA_TBK / 2; ++r) {
      const int kp = kv0 + 8 * (r / 4) + 2 * quad + (r % 2);
      const int qp = qp0 + 8 * ((r / 2) % 2);
      const bool keep = kp < s && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
      if (!keep) sc[r] = __int_as_float(0xff800000);  // −inf
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < FA_TBK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  a0 = fa_exp2(m0 - mx0);
  a1 = fa_exp2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < FA_TBK / 8; ++j) {
    sc[4 * j] = fa_exp2(sc[4 * j] - mx0);
    sc[4 * j + 1] = fa_exp2(sc[4 * j + 1] - mx0);
    sc[4 * j + 2] = fa_exp2(sc[4 * j + 2] - mx1);
    sc[4 * j + 3] = fa_exp2(sc[4 * j + 3] - mx1);
    ps0 += sc[4 * j] + sc[4 * j + 1];
    ps1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = fmaf(l0, a0, ps0);
  l1 = fmaf(l1, a1, ps1);
}

// the weights in bf16: the accumulator's columns 16kk..16kk+15 are A's k16
// step kk, element for element
__device__ __forceinline__ void fa_weights(uint32_t (&pa)[FA_TBK / 16][4],
                                           const float (&sc)[FA_TBK / 2]) {
#pragma unroll
  for (int kk = 0; kk < FA_TBK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = fa_pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
fa_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int hq,
         int hkv, int s, int causal, int window, float scale_log2) {
  using G = FaTile<D>;
  extern __shared__ uint8_t fa_tc_smem[];
  uint8_t* qs = fa_tc_smem + ((1024 - (hop::smem_addr(fa_tc_smem) & 1023)) & 1023);
  uint8_t* ks = qs + G::Q_BYTES;
  uint8_t* vs = ks + FA_STAGES * G::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + FA_STAGES * G::KV_BYTES);
  uint64_t* empty = full + FA_STAGES;
  uint64_t* qbar = empty + FA_STAGES;

  const int bh = blockIdx.x;                                  // b·Hq + query head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_TBQ;       // latest q tiles first
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);   // b·Hkv + its kv head
  // the kv tiles any row of this block attends to: [t_lo, t_lo + n)
  const int hi = causal ? min(s, q0 + FA_TBQ) : s;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = lo / FA_TBK, n = (hi + FA_TBK - 1) / FA_TBK - t_lo;

  if (threadIdx.x == 0) {
    for (int i = 0; i < FA_STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 256);
    }
    hop::mbar_init(qbar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {  // the producer warpgroup: one thread starts every TMA load
    hop::regs_release<FA_PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      hop::tma_prefetch_map(&kmap);
      hop::tma_prefetch_map(&vmap);
      hop::mbar_expect_tx(qbar, G::Q_BYTES);
      for (int x = 0; x < G::NBOX; ++x)
        hop::tma_load_3d(qs + x * G::Q_BOX, &qmap, qbar, x * G::EPB, q0, bh);
      for (int i = 0; i < n; ++i) {
        const int st = i % FA_STAGES;
        hop::mbar_wait(&empty[st], ((i / FA_STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[st], 2 * G::KV_BYTES);
        for (int x = 0; x < G::NBOX; ++x) {
          hop::tma_load_3d(ks + st * G::KV_BYTES + x * G::KV_BOX, &kmap, &full[st], x * G::EPB,
                           (t_lo + i) * FA_TBK, bkv);
          hop::tma_load_3d(vs + st * G::KV_BYTES + x * G::KV_BOX, &vmap, &full[st], x * G::EPB,
                           (t_lo + i) * FA_TBK, bkv);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64·wg + [0, 64); in the
    // accumulators this thread holds rows r0 and r0 + 8 of them, and in
    // each 8-column group the columns 2·quad and 2·quad + 1
    hop::regs_claim<FA_CONSUMER_REGS>();
    const int wg = warp / 4, quad = lane % 4;
    const int r0 = 16 * (warp % 4) + lane / 4;
    const int qw0 = q0 + 64 * wg;
    const uint32_t qaddr = hop::smem_addr(qs) + wg * 64 * G::SWB;
    // sc = Q·Kᵀ of stage st's tile (64 × 128, f32), started, not waited for;
    // D / 16 k16 steps (7 at D = 112: the zero-filled columns are skipped)
    auto logits = [&](float (&sc)[FA_TBK / 2], int st) {
      const uint32_t kaddr = hop::smem_addr(ks + st * G::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % G::KPB) * 32;  // 16 bf16 along the swizzled row
        hop::wgmma_ss_m64n128(
            sc, hop::gmma_desc(qaddr + (kk / G::KPB) * G::Q_BOX + off, 16, 8 * G::SWB, G::SWIZZLE),
            hop::gmma_desc(kaddr + (kk / G::KPB) * G::KV_BOX + off, 16, 8 * G::SWB, G::SWIZZLE),
            kk > 0);
      }
      hop::wgmma_commit();
    };
    // acc += P·V of stage st's tile (64 × DT, f32), started, not waited for;
    // V MN-major: 16 kv rows per k16 step
    auto values = [&](float (&acc)[G::DT / 2], const uint32_t (&pa)[FA_TBK / 16][4], int st) {
      const uint32_t vaddr = hop::smem_addr(vs + st * G::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < FA_TBK / 16; ++kk)
        fa_pv<G::DT>(acc, pa[kk],
                 hop::gmma_desc(vaddr + kk * 16 * G::SWB, G::KV_BOX, 8 * G::SWB, G::SWIZZLE));
      hop::wgmma_commit();
    };
    // the two warpgroups take turns to start their products (barrier 1 + wg
    // is this one's turn): one's tensor-core work then runs while the
    // other's softmax does, instead of both competing at once
    auto my_turn = [&]() { hop::bar_sync(1 + wg, 256); };
    auto your_turn = [&]() { hop::bar_arrive(2 - wg, 256); };
    auto crosses_edge = [&](int kv0) {
      return (causal && kv0 + FA_TBK - 1 > qw0) || (window > 0 && kv0 <= qw0 + 63 - window) ||
             kv0 + FA_TBK > s;
    };

    // acc's columns past D (D = 112: 112–127) stay 0 and are never stored
    float acc[G::DT / 2], sc[FA_TBK / 2];
    uint32_t pa[FA_TBK / 16][4];
#pragma unroll
    for (int i = 0; i < G::DT / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < FA_TBK / 2; ++i) sc[i] = 0.f;
    float m0 = FA_NEG, m1 = FA_NEG, l0 = 0.f, l1 = 0.f, a0, a1;

    // Tile i's logits and softmax run while tile i − 1's P·V is in flight:
    // the tensor cores and the softmax's arithmetic overlap within the
    // warpgroup.
    hop::mbar_wait(qbar, 0);
    if (wg == 1 && n > 0) your_turn();  // warpgroup 0 goes first
    if (n > 0) {
      hop::mbar_wait(&full[0], 0);
      hop::fence_regs(sc);
      hop::wgmma_fence();
      my_turn();
      logits(sc, 0);
      your_turn();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      fa_softmax(sc, crosses_edge(t_lo * FA_TBK), t_lo * FA_TBK, qw0 + r0, quad, s, causal,
                 window, scale_log2, m0, m1, l0, l1, a0, a1);
      fa_weights(pa, sc);
    }
    for (int i = 1; i < n; ++i) {
      const int st = i % FA_STAGES, prev = (i - 1) % FA_STAGES;
      const int kv0 = (t_lo + i) * FA_TBK;
      hop::mbar_wait(&full[st], (i / FA_STAGES) & 1);
      hop::fence_regs(sc);
      hop::fence_regs(acc);
      hop::fence_regs(pa);
      hop::wgmma_fence();
      my_turn();
      logits(sc, st);
      values(acc, pa, prev);
      your_turn();
      hop::wgmma_wait<1>();  // the logits are in; P·V may still run
      hop::fence_regs(sc);
      fa_softmax(sc, crosses_edge(kv0), kv0, qw0 + r0, quad, s, causal, window, scale_log2, m0,
                 m1, l0, l1, a0, a1);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(pa);
      hop::mbar_arrive(&empty[prev]);  // this thread no longer reads the stage
      if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= a0;
          acc[4 * j + 1] *= a0;
          acc[4 * j + 2] *= a1;
          acc[4 * j + 3] *= a1;
        }
      }
      fa_weights(pa, sc);
    }
    if (n > 0) {
      hop::fence_regs(acc);
      hop::fence_regs(pa);
      hop::wgmma_fence();
      my_turn();
      values(acc, pa, (n - 1) % FA_STAGES);
      if (wg == 0) your_turn();  // warpgroup 1's last turn; it has no next
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float den[2] = {l0 == 0.f ? 1.f : l0, l1 == 0.f ? 1.f : l1};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = qw0 + r0 + 8 * h;
      if (qp >= s) continue;
      __nv_bfloat16* row = o + (static_cast<long long>(bh) * s + qp) * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 x =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] / den[h], acc[4 * j + 2 * h + 1] / den[h]);
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = x;
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda
typedef CUresult (*fa_encode_fn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static fa_encode_fn fa_encoder() {
  static fa_encode_fn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<fa_encode_fn>(p);
  }
  return fn;
}

// a (heads, s, d) bf16 tensor as boxes of `rows` positions × `swb` bytes; a
// box that reaches past s rows or d columns is filled with zeros
static bool fa_map(CUtensorMap* map, fa_encode_fn enc, const void* ptr, int heads, int s, int d,
                   int rows, int swb) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(swb / 2), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
static cudaError_t fa_tc_run(const void* q, const void* k, const void* v, void* o, int b, int hq,
                             int hkv, int s, int causal, int window, float scale,
                             cudaStream_t st) {
  using G = FaTile<D>;
  const fa_encode_fn enc = fa_encoder();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!fa_map(&qm, enc, q, b * hq, s, D, FA_TBQ, G::SWB) ||
      !fa_map(&km, enc, k, b * hkv, s, D, FA_TBK, G::SWB) ||
      !fa_map(&vm, enc, v, b * hkv, s, D, FA_TBK, G::SWB))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      fa_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(b * hq, (s + FA_TBQ - 1) / FA_TBQ);
  fa_wgmma<D><<<grid, FA_THREADS, G::SMEM, st>>>(qm, km, vm, static_cast<__nv_bfloat16*>(o), hq,
                                                 hkv, s, causal, window,
                                                 scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 fa_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fa_store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float fa_dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(4 * FA_ROWS, 2)
fa_main(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        float* __restrict__ o, int hq, int hkv, int s, int group, int bq, int causal, int window,
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

template <int D>
static cudaError_t fa_run(const void* q, const void* k, const void* v, void* o, int hq, int hkv,
                          int s, int group, int bq, int causal, int window, float scale,
                          dim3 grid, int threads, cudaStream_t st) {
  const size_t bytes = 2 * sizeof(float) * FA_BK * D;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_main<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  fa_main<D><<<grid, threads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), hq, hkv, s, group, bq, causal, window, scale);
  return cudaGetLastError();
}

// q (b, hq, s, d) and k, v (b, hkv, s, d), contiguous, f32 (bf16 = 0) or
// bf16 (bf16 = 1), 16-byte aligned; o (b, hq, s, d) of q's type is written.
// window ≤ 0 means no window; scale multiplies q (f32) or the logits
// (bf16).  Returns
// cudaErrorInvalidValue for a shape the kernels do not take,
// cudaErrorNotSupported where libcuda has no cuTensorMapEncodeTiled,
// else the first CUDA error met (shared-memory attribute, launch).
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
                         int hkv, int s, int d, int bf16, int causal, int window, float scale,
                         void* stream) {
  if (b < 0 || hkv < 1 || hq < hkv || hq % hkv != 0 || s < 1 ||
      (d != 32 && d != 64 && d != 112 && d != 128))
    return cudaErrorInvalidValue;
  const int group = hq / hkv;
  if (group > FA_MAX_GROUP || static_cast<long long>(b) * hkv > 65535) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if ((s + FA_TBQ - 1) / FA_TBQ > 65535 || static_cast<long long>(b) * hq > 0x7fffffff)
      return cudaErrorInvalidValue;
    if (d == 32) return fa_tc_run<32>(q, k, v, o, b, hq, hkv, s, causal, window, scale, st);
    if (d == 64) return fa_tc_run<64>(q, k, v, o, b, hq, hkv, s, causal, window, scale, st);
    if (d == 112) return fa_tc_run<112>(q, k, v, o, b, hq, hkv, s, causal, window, scale, st);
    return fa_tc_run<128>(q, k, v, o, b, hq, hkv, s, causal, window, scale, st);
  }
  const int bq = group >= FA_ROWS ? 1 : FA_ROWS / group;
  const int nq = (s + bq - 1) / bq;
  const int rows = (group * bq + 7) / 8 * 8;  // whole warps: a quad's shuffles need all 32 lanes
  const dim3 grid(nq, b * hkv);
  const int threads = 4 * rows;
  if (d == 32)
    return fa_run<32>(q, k, v, o, hq, hkv, s, group, bq, causal, window, scale, grid, threads, st);
  if (d == 64)
    return fa_run<64>(q, k, v, o, hq, hkv, s, group, bq, causal, window, scale, grid, threads, st);
  if (d == 112)
    return fa_run<112>(q, k, v, o, hq, hkv, s, group, bq, causal, window, scale, grid, threads, st);
  return fa_run<128>(q, k, v, o, hq, hkv, s, group, bq, causal, window, scale, grid, threads, st);
}
