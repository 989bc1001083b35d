// Device helpers for fp8 (e4m3) operands on their way to Hopper's wgmma:
// the exact decode to f16, the 128-byte swizzle of a tile of 128-byte rows
// and its shared-memory matrix descriptor. Shared by the fp8 dot kernel
// (fp8_dot.cu) and the route probe (fp8_mma_probe.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fp8_tile {

// two e4m3 values (the low byte first) -> f16x2, exactly
__device__ __forceinline__ uint32_t e4m3x2_f16x2(uint32_t pair) {
  uint32_t d;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(d)
      : "h"(static_cast<unsigned short>(pair)));
  return d;
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows under the 128-byte swizzle (TMA's and wgmma's: the chunk index XOR
// the row's index within its group of 8)
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle (layout type 1): 8-row groups 1024 bytes apart; a k-step inside
// the 128-byte row advances the start address
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16)
       | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// The k order inside a 16-byte chunk of 16 e4m3 values. A wgmma A fragment
// holds columns 2c, 2c + 1, 2c + 8, 2c + 9 of a 16-column k-step (c = lane
// % 4); they are taken from bytes 4c .. 4c + 3 of the chunk, so a thread
// reads one 32-bit word a row and k-step. B's 16-bit tile is written in the
// same order: its first 16-byte chunk (columns 0 .. 7) holds the low halves
// of the fp8 chunk's four words, its second (columns 8 .. 15) the high
// halves. A and B are permuted alike, so the sum over k is unchanged.
__device__ __forceinline__ void decode_chunk(uint4 v, uint32_t (&w)[8]) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = e4m3x2_f16x2(in[i] & 0xFFFFu);
    w[4 + i] = e4m3x2_f16x2(in[i] >> 16);
  }
}

}  // namespace fp8_tile
