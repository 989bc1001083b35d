// bf16 flash attention forward on Hopper's tensor cores (sm_90a).
//
// Included by flash_attention.cu, whose entry point flash_attention_fwd
// sends bf16 inputs here; the head note of that file gives the design and
// what bounds it. This file holds the PTX wrappers (mbarrier, TMA, wgmma)
// and the kernel.
//
// Block: 2 warpgroups of 64 query rows each (128 consecutive rows of one q
// head), 8 warps, so that a thread may hold up to 255 registers: a ninth
// warp (a producer warp or warpgroup) puts three warps on one SM
// sub-partition and holds every thread to 168, and ptxas would not lift
// that for setmaxnreg. Thread 0 issues every copy: the block's Q once, then
// K and V tiles of kBK keys by TMA into a ring of kStages shared-memory
// stages ("full" barrier per stage, completed by the copy's byte count;
// "empty" barrier per stage, one arrival per warp), refilling a stage as
// soon as all eight warps have released it. A warpgroup runs, per tile,
//   S = Q K^T                     wgmma m64n64k16, A and B in shared memory
//   T = (P_lo + P_mid + P_hi) V   wgmma m64nDVk16, A in registers, into a
//                                 fresh accumulator
//   O = O * corr + T              f32 on the CUDA cores
// and overlaps the softmax of tile i+1 with the P V product of tile i.
//
// Shared-memory layout of a tile (Q, K: D columns, V: DV columns), as TMA's
// 32-byte swizzle writes it and wgmma's 32-byte-swizzle descriptors read it:
// [column chunk of 16][row][16 values], one 32-byte row per key (or query
// row) and chunk. The tensor map's five dimensions are (16 values, row,
// chunk, head, batch) with the chunk stride 32 bytes, so one copy fetches a
// whole tile of a strided view. Q and K are K-major operands of S (a k-step
// of 16 columns is one chunk); V is the MN-major (transposed) B operand of
// P V (a k-step is 16 keys, two 8-key groups 256 bytes apart; chunks of 16
// values kBK * 32 bytes apart).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only; the encoder is reached
                    // through cudaGetDriverEntryPoint (no -lcuda)
#include "quantize_em.cuh"

namespace fa_sm90 {

using repro_q::RowParams;
using repro_q::derive_row;
using repro_q::store_epilogue;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                 // keys per tile: N of S = Q K^T
constexpr int kRows = 64;               // query rows per warpgroup
constexpr int kGroups = 2;              // warpgroups per block
constexpr int kBQ = kRows * kGroups;    // query rows per block
constexpr int kStages = 4;              // K/V ring depth
constexpr int kThreads = 128 * kGroups;
constexpr int kChunkBytes = kBK * 32;   // one 16-column chunk of a tile
constexpr float kNegInf = -1e30f;       // the reference's mask constant
constexpr float kLog2e = 1.4426950408889634f;
// a pipeline wait that has not advanced for this long traps instead of
// hanging the card (a stage is refilled within microseconds)
constexpr unsigned long long kStuckNs = 4000000000ull;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until the barrier's phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  for (uint32_t n = 1;; ++n) {
    if (mbar_try_wait(bar, parity)) return;
    if ((n & 255u) == 0 && global_ns() - t0 > kStuckNs) __trap();
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait (the asynchronous product writes them behind its back)
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// shared-memory matrix descriptor, 32-byte swizzle (layout type 3); byte
// offsets: lbo between 16-value chunks of an MN-major operand (unused for
// K-major), sbo between 8-row groups
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)
       | ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16)
       | ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32)
       | (3ull << 62);
}

// D (64 x N, f32) += A (64 x 16 bf16, registers) * B (16 x N bf16, shared
// memory); TB = 1 reads B transposed (MN-major). scale_d = 0 overwrites D.
// Accumulator of thread (warp w, lane l): d[4j + 2h + e] is row
// 16w + l/4 + 8h, column 8j + 2(l%4) + e; A fragment a[0..3] holds rows
// l/4 and l/4 + 8, columns 2(l%4) + {0,1} and + 8 (the mma.sync m16n8k16 A
// layout per warp).
// D (64 x 64, f32) (+)= A (64 x 16, shared memory) * B (16 x 64, shared
// memory), both K-major; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N, int TB> struct WgmmaRS;

template <int TB> struct WgmmaRS<16, TB> {
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

template <int TB> struct WgmmaRS<32, TB> {
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

template <int TB> struct WgmmaRS<64, TB> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

template <int TB> struct WgmmaRS<80, TB> {
  __device__ __forceinline__ static void mma(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

template <int TB> struct WgmmaRS<128, TB> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

struct Args {
  bf16* out;
  const int32_t* row;                   // nullptr: no epilogue
  int Hq, Hkv, S;
  int causal, window;                   // window <= 0: no window
  float c;                              // scale * log2(e)
};

// key tiles [lo, hi) that the 64 rows from r0 on can see
struct Tiles { int lo, hi; };

__device__ __forceinline__ Tiles tiles_of(int r0, const Args& a) {
  int key_lo = 0, key_hi = a.S;
  if (a.causal) key_hi = min(a.S, r0 + kRows);
  if (a.window > 0) key_lo = max(0, r0 - a.window + 1);
  return {key_lo / kBK, (key_hi + kBK - 1) / kBK};
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, which no sum of this kernel can see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// One warpgroup's 64 x kBK scores (the thread's rows row0 and row0 + 8)
// become probabilities in place, in f32; the rows' running max m (in the
// log2 domain, scale folded in) and denominator l are updated and the
// accumulator's correction factors returned in corr. Only a tile that
// crosses the diagonal, the window's edge or S computes the mask; a masked
// score is the reference's -1e30.
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int row0, int k0, int cq,
                                             bool masked, const Args& a) {
  float mx[2] = {kNegInf, kNegInf};
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = row0 + 8 * h, kj = k0 + 8 * j + 2 * cq + e;
          const bool ok = kj < a.S && (!a.causal || qi >= kj) &&
                          (a.window <= 0 || qi - kj < a.window);
          float& x = s[4 * j + 2 * h + e];
          x = ok ? __fmul_rn(x, a.c) : kNegInf;
          mx[h] = fmaxf(mx[h], x);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      corr[h] = ex2(__fsub_rn(m[h], mn));
      m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = ex2(__fsub_rn(x, m[h]));
        }
  } else {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) mx[h] = fmaxf(mx[h], s[4 * j + 2 * h + e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], __fmul_rn(quad_max(mx[h]), a.c));
      corr[h] = ex2(__fsub_rn(m[h], mn));
      m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = ex2(__fmaf_rn(x, a.c, -m[h]));
        }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) sum = __fadd_rn(sum, s[4 * j + 2 * h + e]);
    l[h] = __fmaf_rn(l[h], corr[h], quad_sum(sum));
  }
}

// P (f32, the S accumulator's layout) -> three bf16 A operands of P V:
// hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid) (both
// differences exact), so hi + mid + lo is p within 2^-24 p. Key block kk of
// 16 is the A fragment of k-step kk.
__device__ __forceinline__ void split_bf16(const float (&p)[kBK / 2],
                                           uint32_t (&hi)[kBK / 16][4],
                                           uint32_t (&mid)[kBK / 16][4],
                                           uint32_t (&lo)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = p[8 * kk + 2 * i], x1 = p[8 * kk + 2 * i + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h2);
      const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
      const __nv_bfloat162 m2 = __floats2bfloat162_rn(r0, r1);
      const float2 mf = __bfloat1622float2(m2);
      hi[kk][i] = bits(h2);
      mid[kk][i] = bits(m2);
      lo[kk][i] = bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x),
                                             __fsub_rn(r1, mf.y)));
    }
}

// S = Q K^T over one K tile (NK k-steps of 16 columns)
template <int NK>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t q_tile,
                                         uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_ss_n64(s, desc_sw32(q_tile + kk * kChunkBytes, 16, 256),
                 desc_sw32(k_tile + kk * kChunkBytes, 16, 256), kk > 0);
  wgmma_commit();
}

// T = P V over one V tile (kBK / 16 k-steps of 16 keys) into a fresh
// accumulator: the tensor cores' f32 sums lose ~2^-23 of the accumulator's
// magnitude a step, so a tile's 12 steps stay short, the small terms go
// first, and the running O is summed on the CUDA cores
template <int DV>
__device__ __forceinline__ void issue_pv(float (&t)[DV / 2],
                                         const uint32_t (&hi)[kBK / 16][4],
                                         const uint32_t (&mid)[kBK / 16][4],
                                         const uint32_t (&lo)[kBK / 16][4],
                                         uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    WgmmaRS<DV, 1>::mma(t, lo[kk],
                        desc_sw32(v_tile + kk * 16 * 32, kChunkBytes, 256),
                        kk > 0);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    WgmmaRS<DV, 1>::mma(t, mid[kk],
                        desc_sw32(v_tile + kk * 16 * 32, kChunkBytes, 256), 1);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    WgmmaRS<DV, 1>::mma(t, hi[kk],
                        desc_sw32(v_tile + kk * 16 * 32, kChunkBytes, 256), 1);
  wgmma_commit();
}

// O = O * corr + T, the thread's rows row0 (h = 0) and row0 + 8 (h = 1)
template <int DV>
__device__ __forceinline__ void merge(float (&o)[DV / 2],
                                      const float (&t)[DV / 2],
                                      const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[4 * j + 2 * h + e] =
            __fmaf_rn(o[4 * j + 2 * h + e], corr[h], t[4 * j + 2 * h + e]);
}

// DV: the head dim of q, k and v alike (the binding pads to one of five)
template <int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Args a) {
  constexpr int NK = DV / 16;                    // k-steps of S = Q K^T
  constexpr uint32_t kTile = kChunkBytes * NK;   // a Q block, K or V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kGroups * kTile;
  const uint32_t sV = sK + kStages * kTile;
  const uint32_t full0 = sV + kStages * kTile;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;

  // heads fastest: the q heads of one KV head run side by side and share
  // its tiles in L2; the longest q blocks (most keys) first
  const int n_qb = (a.S + kBQ - 1) / kBQ;
  const int h = blockIdx.x % a.Hq;
  const int q0 = (n_qb - 1 - (int)(blockIdx.x / a.Hq)) * kBQ;
  const int b = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  // tiles of the block: from the first warpgroup's first to the second's last
  const int lo = tiles_of(q0, a).lo;
  const int n = tiles_of(q0 + kRows, a).hi - lo;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32, cq = lane % 4;
  const int r0 = q0 + wg * kRows;                 // the warpgroup's 64 rows
  const int row0 = r0 + 16 * (t / 32) + lane / 4;     // the thread's: row0, +8
  const uint32_t q_tile = sQ + wg * kTile;
  // thread 0 issues every copy: the block's Q once, then K/V tile i + kStages
  // as soon as every warp has released tile i from its stage
  const bool producer = threadIdx.x == 0;
  auto load = [&](int i) {
    const int st = i % kStages;
    if (i >= kStages) mbar_wait(empty0 + 8 * st, (i / kStages - 1) & 1);
    mbar_expect_tx(full0 + 8 * st, 2 * kTile);
    tma_load_5d(sK + st * kTile, &tk, full0 + 8 * st, 0, (lo + i) * kBK, 0,
                hk, b);
    tma_load_5d(sV + st * kTile, &tv, full0 + 8 * st, 0, (lo + i) * kBK, 0,
                hk, b);
  };

  if (producer) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 4 * kGroups);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(qbar, kGroups * kTile);
    for (int w = 0; w < kGroups; ++w)
      tma_load_5d(sQ + w * kTile, &tq, qbar, 0, q0 + w * kRows, 0, h, b);
    for (int i = 0; i < min(n, kStages); ++i) load(i);
  }
  __syncthreads();

  // this warpgroup's tiles [i_lo, i_hi) of the block's n; it still waits
  // for and releases the others, so that every stage sees every arrival
  const Tiles own = tiles_of(r0, a);
  int i_lo = own.lo - lo, i_hi = own.hi - lo;
  if (own.lo >= own.hi) i_lo = i_hi = n;          // all rows past S

  float s[kBK / 2], tacc[DV / 2], o[DV / 2];
  uint32_t ph[kBK / 16][4], pm[kBK / 16][4], pl[kBK / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float corr[2], corr_i[2];
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) o[j] = 0.0f;

  auto wait_full = [&](int i) {
    mbar_wait(full0 + 8 * (i % kStages), (i / kStages) & 1);
  };
  // this warp is done with tile i; the producer refills its stage
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (i % kStages));
    if (producer && i + kStages < n) load(i + kStages);
  };
  // does some (row, key) pair of tile i fall outside the mask?
  auto masked = [&](int i) {
    const int k0 = (lo + i) * kBK;
    return k0 + kBK > a.S || (a.causal && k0 + kBK - 1 > r0) ||
           (a.window > 0 && r0 + kRows - 1 - k0 >= a.window);
  };
  auto k_tile = [&](int i) { return sK + (i % kStages) * kTile; };
  auto v_tile = [&](int i) { return sV + (i % kStages) * kTile; };

  for (int i = 0; i < i_lo; ++i) { wait_full(i); release(i); }
  if (i_lo < i_hi) {
    mbar_wait(qbar, 0);
    wait_full(i_lo);
    issue_qk<NK>(s, q_tile, k_tile(i_lo));
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, corr, row0, (lo + i_lo) * kBK, cq, masked(i_lo), a);
    split_bf16(s, ph, pm, pl);
    // the next tile's S and this tile's P V go to the tensor cores
    // together; the next tile's softmax runs while P V is in flight
    for (int i = i_lo; i < i_hi - 1; ++i) {
      wait_full(i + 1);
      issue_qk<NK>(s, q_tile, k_tile(i + 1));
      issue_pv<DV>(tacc, ph, pm, pl, v_tile(i));
      corr_i[0] = corr[0];
      corr_i[1] = corr[1];
      wgmma_wait<1>();
      fence_regs(s);
      softmax_tile(s, m, l, corr, row0, (lo + i + 1) * kBK, cq, masked(i + 1),
                   a);
      wgmma_wait<0>();
      fence_regs(tacc);
      release(i);
      merge<DV>(o, tacc, corr_i);
      split_bf16(s, ph, pm, pl);
    }
    issue_pv<DV>(tacc, ph, pm, pl, v_tile(i_hi - 1));
    wgmma_wait<0>();
    fence_regs(tacc);
    release(i_hi - 1);
    merge<DV>(o, tacc, corr);
  }
  for (int i = i_hi; i < n; ++i) { wait_full(i); release(i); }

  // epilogue: normalise, store in bf16, the row's quantize if wired in
  const bool fused = a.row != nullptr;
  RowParams prm = {};
  if (fused) prm = derive_row(a.row);
  bf16* out = a.out + ((long long)b * a.Hq + h) * a.S * DV;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = row0 + 8 * hh;
    if (qi >= a.S) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        store_epilogue<bf16>(out + (long long)qi * DV + 8 * j + 2 * cq + e,
                             __fdiv_rn(o[4 * j + 2 * hh + e], denom), fused,
                             prm);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a failed cuTensorMapEncodeTiled returns kEncodeError + its CUresult
constexpr int kEncodeError = 10000;

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of q, k or v (B, H, S, cols), bf16, strides in elements, as
// five dimensions (16 values, row, 16-value chunk, head, batch): a box of
// (16, 64, cols / 16, 1, 1) is one tile. Rows past S read as zeros.
inline int tile_map(CUtensorMap* map, const void* ptr, int cols, int S, int H,
                    int B, long long s_s, long long s_h, long long s_b) {
  static_assert(kBK == kRows, "one box shape serves Q blocks and K/V tiles");
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // an axis of extent 1 has no stride that matters: give it one TMA takes
  const cuuint64_t st_s = S > 1 ? (cuuint64_t)s_s * 2 : (cuuint64_t)cols * 2;
  const cuuint64_t st_h = H > 1 ? (cuuint64_t)s_h * 2 : st_s * S;
  const cuuint64_t st_b = B > 1 ? (cuuint64_t)s_b * 2 : st_h * H;
  const cuuint64_t dims[5] = {16, (cuuint64_t)S, (cuuint64_t)(cols / 16),
                              (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[4] = {st_s, 32, st_h, st_b};
  const cuuint32_t box[5] = {16, kBK, (cuuint32_t)(cols / 16), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (cols % 16 || reinterpret_cast<uintptr_t>(ptr) % 16 || st_s % 16 ||
      st_h % 16 || st_b % 16 || st_s == 0 || st_h == 0 || st_b == 0)
    return (int)cudaErrorInvalidValue;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_32B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int DV>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Args& a, int B, cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)kChunkBytes * (DV / 16)
      * (kGroups + 2 * kStages) + 8 * (2 * kStages + 1);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_sm90<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Hq * ((a.S + kBQ - 1) / kBQ), B);
  flash_fwd_bf16_sm90<DV><<<grid, kThreads, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// q (B, Hq, S, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv), bf16, unit stride on
// the last axis, D == Dv one of 16, 32, 64, 80, 128, and in TMA's terms:
// 16-byte aligned bases, batch / head / sequence strides multiples of 8
// elements. out (B, Hq, S, Dv) contiguous.
inline int flash_fwd_bf16(const void* q, const void* k, const void* v,
                          void* out, const void* row, long long qs_b,
                          long long qs_h, long long qs_s, long long ks_b,
                          long long ks_h, long long ks_s, long long vs_b,
                          long long vs_h, long long vs_s, int B, int Hq,
                          int Hkv, int S, int D, int Dv, int causal,
                          int window, float scale, cudaStream_t stream) {
  if (D != Dv) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = tile_map(&tq, q, D, S, Hq, B, qs_s, qs_h, qs_b);
  if (!err) err = tile_map(&tk, k, D, S, Hkv, B, ks_s, ks_h, ks_b);
  if (!err) err = tile_map(&tv, v, Dv, S, Hkv, B, vs_s, vs_h, vs_b);
  if (err) return err;
  Args a;
  a.out = static_cast<bf16*>(out);
  a.row = static_cast<const int32_t*>(row);
  a.Hq = Hq; a.Hkv = Hkv; a.S = S;
  a.causal = causal; a.window = window;
  a.c = scale * kLog2e;
  switch (Dv) {
    case 16: return launch<16>(tq, tk, tv, a, B, stream);
    case 32: return launch<32>(tq, tk, tv, a, B, stream);
    case 64: return launch<64>(tq, tk, tv, a, B, stream);
    case 80: return launch<80>(tq, tk, tv, a, B, stream);
    case 128: return launch<128>(tq, tk, tv, a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fa_sm90
