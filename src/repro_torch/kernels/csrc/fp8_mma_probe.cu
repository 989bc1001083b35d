// Step 0 of the fp8 dot kernel's design (fp8_dot.cu): which tensor-core
// route holds its contract -- exact products of e4m3 values summed in f32,
// every finite element within K * 2^-23 * (|A| @ |B|) of an f32 matmul of
// the decoded operands. A measurement, not a kernel of any path: built
// only when chip_smoke.py's fp8_probe phase runs
// (repro_torch.kernels.fp8_dot.mma_probe).
//
// One warpgroup computes a 64 x 64 block of A (M x Kp) * B (N x Kp)^T from
// packed operands through one route: the fp8 wgmma on the fp8 tiles, or
// the f16 / bf16 wgmma on the same values decoded exactly. Its accumulator
// starts fresh and is added into f32 registers after every `promote`
// instructions (0: once, at the end). Plain loads and a block barrier per
// k-tile: a measurement of the sums, not of speed.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp8_tile.cuh"
#include "sm90.cuh"

namespace {

using namespace fp8_tile;
using namespace sm90;

// f16x2 -> bf16x2 (exact for decoded e4m3 values)
__device__ __forceinline__ uint32_t f16x2_bf16x2(uint32_t h) {
  const float lo = __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
  const float hi = __half2float(__ushort_as_half(static_cast<unsigned short>(h >> 16)));
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// a decoded chunk's eight f16x2 words as bf16x2
__device__ __forceinline__ void to_bf16(uint32_t (&w)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = f16x2_bf16x2(w[i]);
}

enum Route { kFp8 = 0, kF16 = 1, kBf16 = 2 };

template <int R> struct Wgmma;

template <> struct Wgmma<kFp8> {
  static constexpr int kK = 32;   // depth of one instruction
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<kF16> {
  static constexpr int kK = 16;   // depth of one instruction
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
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
};

template <> struct Wgmma<kBf16> {
  static constexpr int kK = 16;   // depth of one instruction
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
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
};

template <int R>
__global__ void __launch_bounds__(128)
fp8_mma_probe_kernel(const uint8_t* __restrict__ A,
                     const uint8_t* __restrict__ B, float* __restrict__ C,
                     int N, int Kp, int promote) {
  constexpr int kRows = 64;
  // fp8: one 64 x 128-byte tile per operand; 16-bit: two halves of 64 k
  constexpr uint32_t kOp = R == kFp8 ? kRows * 128 : 2 * kRows * 128;
  __shared__ unsigned char smem[2 * kOp + 1024];
  // the swizzle's 8-row groups start at multiples of 1024 bytes
  const uint32_t sa = (smem_u32(smem) + 1023u) & ~1023u, sb = sa + kOp;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kRows;
  float o[32], acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = acc[j] = 0.0f;
  int issued = 0;
  for (int k0 = 0; k0 < Kp; k0 += 128) {
    for (int q = t; q < kRows * 8; q += 128) {   // 16-byte chunks
      const int row = q >> 3, j = q & 7;
      const uint4 va = *reinterpret_cast<const uint4*>(
          A + static_cast<long long>(m0 + row) * Kp + k0 + 16 * j);
      const uint4 vb = *reinterpret_cast<const uint4*>(
          B + static_cast<long long>(n0 + row) * Kp + k0 + 16 * j);
      if (R == kFp8) {
        sts128(sa + sw128(row, j), va.x, va.y, va.z, va.w);
        sts128(sb + sw128(row, j), vb.x, vb.y, vb.z, vb.w);
      } else {
        uint32_t w[8];
        const uint32_t h = (j >> 2) * (kRows * 128);
        decode_chunk(va, w);
        if (R == kBf16) to_bf16(w);
        sts128(sa + h + sw128(row, (2 * j) & 7), w[0], w[1], w[2], w[3]);
        sts128(sa + h + sw128(row, (2 * j + 1) & 7), w[4], w[5], w[6], w[7]);
        decode_chunk(vb, w);
        if (R == kBf16) to_bf16(w);
        sts128(sb + h + sw128(row, (2 * j) & 7), w[0], w[1], w[2], w[3]);
        sts128(sb + h + sw128(row, (2 * j + 1) & 7), w[4], w[5], w[6], w[7]);
      }
    }
    fence_proxy_async();
    __syncthreads();
    for (int kk = 0; kk < 128 / Wgmma<R>::kK; ++kk) {
      const uint32_t off = R == kFp8 ? kk * 32
                                     : (kk >> 2) * (kRows * 128) + (kk & 3) * 32;
      const bool fresh = issued == 0 || (promote > 0 && issued % promote == 0);
      wgmma_fence();
      Wgmma<R>::mma(acc, desc_sw128(sa + off), desc_sw128(sb + off), !fresh);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      ++issued;
      if (promote > 0 && issued % promote == 0) {
#pragma unroll
        for (int j = 0; j < 32; ++j) o[j] = __fadd_rn(o[j], acc[j]);
      }
    }
    __syncthreads();
  }
  if (promote == 0 || issued % promote != 0) {
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] = __fadd_rn(o[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        C[static_cast<long long>(m0 + 16 * warp + lane / 4 + 8 * h) * N +
          n0 + 8 * j + 2 * (lane % 4) + e] = o[4 * j + 2 * h + e];
}

}  // namespace

// The step-0 probe: A (M, Kp), B (N, Kp) packed, M and N multiples of 64,
// C (M, N) f32. route: 0 fp8, 1 f16, 2 bf16.
extern "C" int fp8_mma_probe(const void* A, const void* B, void* C, int M,
                             int N, int Kp, int route, int promote,
                             void* stream) {
  if (M % 64 || N % 64 || Kp % 128 || promote < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / 64, M / 64);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* a = static_cast<const uint8_t*>(A);
  const uint8_t* b = static_cast<const uint8_t*>(B);
  float* c = static_cast<float*>(C);
  switch (route) {
    case kFp8:
      fp8_mma_probe_kernel<kFp8><<<grid, 128, 0, st>>>(a, b, c, N, Kp, promote);
      break;
    case kF16:
      fp8_mma_probe_kernel<kF16><<<grid, 128, 0, st>>>(a, b, c, N, Kp, promote);
      break;
    case kBf16:
      fp8_mma_probe_kernel<kBf16><<<grid, 128, 0, st>>>(a, b, c, N, Kp, promote);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
