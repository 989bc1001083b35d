// Native fp8 (e4m3) dot with f32 sums on Hopper's tensor cores: the
// execution path of `truncate(..., native_fp8=True)` for
// `quantize_dot_inputs` dot sites.
//
// Replaces: src/repro/kernels/fp8_dot.py::fp8_dot_general (the reference's
// `lax.dot_general` on float8_e4m3fn operands with
// preferred_element_type=f32; not a Pallas kernel, XLA's dot).
//
// C[b, m, n] = sum_k A[b, m, k] * B[b, n, k]: A and B float8_e4m3fn packed
// K-major by the wrapper, (batch, M, Kp) and (batch, N, Kp) contiguous, K
// zero-padded to Kp, a multiple of 128; C contiguous (batch, M, N) in f32,
// bf16 or f16, rounded once from the f32 sum.
//
// The contract is the reference's: exact products of e4m3 values summed in
// f32, every finite element within K * 2^-23 * (|A| @ |B|) of an f32
// matmul of the decoded operands, NaN where it has NaN.
//
// Bound on this card: operations. At h2o-danube-1.8b's MLP shapes
// (8192 x 2560 x 13824, 8192 x 6912 x 2560) the 580 / 290 GFLOP take
// 0.29 / 0.15 ms at the fp8 tensor-core rate (1979 TFLOP/s), 0.59 / 0.29 ms
// at the f16 rate this kernel runs at, against 0.08 / 0.04 ms for the bytes.
//
// Route. The fp8 wgmma (m64nNk32.f32.e4m3.e4m3) keeps too few bits in its
// internal sum to hold the bound at small K even when its accumulator is
// promoted into f32 registers after every instruction (the step-0 probe,
// fp8_mma_probe.cu, measures it on the card; chip_smoke.py's fp8_probe
// phase reports it). Every e4m3 value is exactly an f16 value
// (4 significant bits, exponents 2^-9 .. 2^8), and the f16 wgmma sums in
// f32, so this kernel decodes the fp8 tiles to f16 on their way to the
// tensor cores (one cvt.rn.f16x2.e4m3x2 per pair) and runs
// m64n128k16.f32.f16.f16 into a fresh accumulator per k-tile of 128,
// added into f32 registers on the CUDA cores: the tensor core's sum runs
// over 8 instructions, the probe holds it within the bound.
//
// Design. A block computes a 128 x 128 output tile with 2 warpgroups of
// 64 rows each, 8 warps: a ninth warp (a producer warp or warpgroup) puts
// three warps on an SM sub-partition and holds every thread to 168
// registers, and ptxas allocates for that bound whatever setmaxnreg asks
// at run time (measured: 508 bytes of spills with a producer warpgroup and
// setmaxnreg 40 / 232), while a thread here holds 2 x 64 f32 sums and two
// k-tiles of A fragments. So, as in the bf16 flash kernel, thread 0 issues
// every copy: TMA loads of the A and B fp8 tiles (128 rows x 128 bytes
// each, 2-D tensor maps, 128-byte swizzle; the M and N edges read zeros)
// into a ring of kStages stages, each under a "full" mbarrier completed by
// the copy's byte count and an "empty" one that the 8 warps arrive on,
// refilling a stage once every warp has released it. Per k-tile every
// thread decodes a share of the B tile into an f16 buffer in wgmma's
// K-major 128-byte-swizzle layout (two buffers, alternating), decodes its
// own A rows into wgmma's register fragments, releases the stage, and the
// two warpgroups meet at a barrier; then each issues 8 wgmma (A from
// registers, B from the f16 buffer). The decode of tile i + 1 runs while
// tile i's wgmma run; the promotion into the f32 sums, the barrier and the
// refill run while the tensor cores wait. Two variants that hide those
// were slower on the card and were dropped: the tile as two 64-column
// halves whose promotions overlap the other half's wgmma (255 registers),
// and thread 0 refilling a stage right after its own release (its warp
// then waits for the slowest one before its wgmma).
// The epilogue rounds each f32 sum once to the output type and stores it
// with the M and N edges masked. No split-K and no atomics: a result is
// the same from run to run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp8_tile.cuh"
#include "sm90.cuh"

namespace {

using namespace fp8_tile;
using namespace sm90;

constexpr int kBM = 128, kBN = 128, kBK = 128;    // output tile, k-tile
constexpr int kStages = 4;                        // TMA ring depth
constexpr int kThreads = 256;                     // 2 warpgroups
constexpr uint32_t kTile = kBM * kBK;             // one fp8 tile: 16 KB
constexpr uint32_t kStage = 2 * kTile;            // A and B
constexpr uint32_t kHalf = kBN * 64 * 2;          // 64 k of the f16 B tile
constexpr uint32_t kBuf = 2 * kHalf;              // the f16 B tile: 32 KB
constexpr size_t kSmem = 1024 + kStages * kStage + 2 * kBuf + 16 * kStages;

static_assert(kBM == kBN, "one fp8 tile shape serves A and B");

// An fp8 tile (Rows x 128 bytes, 128-byte swizzle) decoded by N threads
// into the 16-bit K-major layout wgmma reads: two halves of 64 k (Rows x
// 128 bytes each, `half` bytes apart), 128-byte swizzle. Eight neighbouring
// threads take chunks 0-3 of row 2p and 4-7 of row 2p + 1, or 4-7 and 0-3:
// their reads and both of their writes hit eight different 16-byte bank
// groups.
template <int Rows, int N>
__device__ __forceinline__ void decode_tile(uint32_t src, uint32_t dst,
                                            uint32_t half, int t) {
  static_assert(Rows * 8 % N == 0, "whole chunks per thread");
#pragma unroll
  for (int u = 0; u < Rows * 8 / N; ++u) {
    const int q = t + u * N, l8 = q & 7, g = q >> 3;
    const int row = 2 * (g >> 1) + (l8 >> 2);
    const int j = (((l8 >> 2) ^ (g & 1)) << 2) | (l8 & 3);
    uint32_t w[8];
    decode_chunk(lds128(src + sw128(row, j)), w);
    const uint32_t d = dst + (j >> 2) * half;
    sts128(d + sw128(row, (2 * j) & 7), w[0], w[1], w[2], w[3]);
    sts128(d + sw128(row, (2 * j + 1) & 7), w[4], w[5], w[6], w[7]);
  }
}

// D (64 x 128, f32) (+)= A (64 x 16 f16, registers) * B (16 x 128 f16,
// shared memory, K-major); scale_d = 0 overwrites D. Accumulator of thread
// (warp w, lane l): d[4j + 2h + e] is row 16w + l/4 + 8h, column
// 8j + 2(l%4) + e; A fragment: a[0], a[1] rows l/4 and l/4 + 8 at columns
// 2(l%4) + {0, 1}, a[2], a[3] the same rows 8 columns on.
__device__ __forceinline__ void wgmma_rs_n128_f16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


// output tile (tm, tn) of block `id`: groups of 8 row tiles walk the column
// tiles together, so neighbouring blocks share A and B tiles in L2
__device__ __forceinline__ void raster(int id, int tiles_m, int tiles_n,
                                       int& tm, int& tn) {
  constexpr int kGroup = 8;
  const int per_group = kGroup * tiles_n;
  const int first = (id / per_group) * kGroup;
  const int rows = min(tiles_m - first, kGroup);
  const int r = id % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

template <typename Out> __device__ Out to_out(float x);
template <> __device__ float to_out<float>(float x) { return x; }
template <> __device__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __half to_out<__half>(float x) {
  return __float2half_rn(x);
}

template <typename Out> struct Pair;
template <> struct Pair<float> {
  using T = float2;
  __device__ static T make(float a, float b) { return make_float2(a, b); }
};
template <> struct Pair<__nv_bfloat16> {
  using T = __nv_bfloat162;
  __device__ static T make(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <> struct Pair<__half> {
  using T = __half2;
  __device__ static T make(float a, float b) { return __floats2half2_rn(a, b); }
};

template <typename Out>
__global__ void __launch_bounds__(kThreads, 1)
fp8_dot_sm90(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb, Out* __restrict__ C,
             int M, int N, int Kp) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base;                    // stage s: A, then B
  const uint32_t bufs = ring + kStages * kStage; // two f16 B tiles
  const uint32_t full0 = bufs + 2 * kBuf;
  const uint32_t empty0 = full0 + 8 * kStages;

  int tm, tn;
  raster(blockIdx.x, (M + kBM - 1) / kBM, (N + kBN - 1) / kBN, tm, tn);
  const int b = blockIdx.y, m0 = tm * kBM, n0 = tn * kBN;
  const int nk = Kp / kBK;

  // thread 0 issues every copy: tile i into stage i % kStages once every
  // warp has released the tile before it there
  auto load = [&](int i) {
    const int s = i % kStages;
    if (i >= kStages) mbar_wait(empty0 + 8 * s, (i / kStages - 1) & 1);
    mbar_expect_tx(full0 + 8 * s, kStage);
    tma_load_2d(ring + s * kStage, &ta, full0 + 8 * s, i * kBK, b * M + m0);
    tma_load_2d(ring + s * kStage + kTile, &tb, full0 + 8 * s, i * kBK,
                b * N + n0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kThreads / 32);
    }
    mbar_init_fence();
    for (int i = 0; i < min(nk, kStages); ++i) load(i);
  }
  __syncthreads();

  const int ct = threadIdx.x;
  const int wg = ct / 128, t = ct % 128;
  const int warp = t / 32, lane = t % 32;
  const int row = 64 * wg + 16 * warp + lane / 4;  // the thread's: row, +8
  const int c2 = 2 * (lane % 4);

  float o[64], acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) o[j] = 0.0f;
  uint32_t a0[8][4], a1[8][4];

  // tile i: wait for its stage, decode B into `buf` and this thread's A
  // fragments into `a`, release the stage
  auto stage_in = [&](int i, uint32_t (&a)[8][4], uint32_t buf) {
    const int s = i % kStages;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    const uint32_t sa = ring + s * kStage;
    decode_tile<kBN, kThreads>(sa + kTile, buf, kHalf, ct);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // bytes 4c .. 4c + 3 of chunk kk (decode_chunk's k order); row + 8
      // has the same swizzle
      const uint32_t lo = sa + sw128(row, kk) + 2 * c2;
      const uint32_t w0 = lds32(lo), w1 = lds32(lo + 8 * 128);
      a[kk][0] = e4m3x2_f16x2(w0 & 0xFFFFu);
      a[kk][1] = e4m3x2_f16x2(w1 & 0xFFFFu);
      a[kk][2] = e4m3x2_f16x2(w0 >> 16);
      a[kk][3] = e4m3x2_f16x2(w1 >> 16);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    fence_proxy_async();
  };
  // 8 wgmma of one k-tile into the fresh accumulator
  auto issue = [&](const uint32_t (&a)[8][4], uint32_t buf) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_n128_f16(acc, a[kk],
                        desc_sw128(buf + (kk >> 2) * kHalf + (kk & 3) * 32),
                        kk > 0);
    wgmma_commit();
  };
  auto promote = [&]() {
#pragma unroll
    for (int j = 0; j < 64; ++j) o[j] = __fadd_rn(o[j], acc[j]);
  };
  // every thread has decoded tile i and released its stage: the stage
  // takes tile i + kStages
  auto sync = [&](int i) {
    __syncthreads();
    if (threadIdx.x == 0 && i + kStages < nk) load(i + kStages);
  };

  stage_in(0, a0, bufs);
  sync(0);
  for (int i = 0; i < nk; i += 2) {
    issue(a0, bufs);
    if (i + 1 < nk) stage_in(i + 1, a1, bufs + kBuf);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a0[0]); fence_regs(a0[1]); fence_regs(a0[2]); fence_regs(a0[3]);
    fence_regs(a0[4]); fence_regs(a0[5]); fence_regs(a0[6]); fence_regs(a0[7]);
    promote();
    if (i + 1 >= nk) break;
    sync(i + 1);
    issue(a1, bufs + kBuf);
    if (i + 2 < nk) stage_in(i + 2, a0, bufs);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a1[0]); fence_regs(a1[1]); fence_regs(a1[2]); fence_regs(a1[3]);
    fence_regs(a1[4]); fence_regs(a1[5]); fence_regs(a1[6]); fence_regs(a1[7]);
    promote();
    if (i + 2 < nk) sync(i + 2);
  }

  // epilogue: each sum rounded once; rows past M, columns past N dropped
  Out* Cb = C + static_cast<long long>(b) * M * N;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + row + 8 * h;
    if (gm >= M) continue;
    Out* Cr = Cb + static_cast<long long>(gm) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gn = n0 + 8 * j + c2;
      const float v0 = o[4 * j + 2 * h], v1 = o[4 * j + 2 * h + 1];
      if (pairs && gn + 1 < N) {
        *reinterpret_cast<typename Pair<Out>::T*>(Cr + gn) =
            Pair<Out>::make(v0, v1);
      } else {
        if (gn < N) Cr[gn] = to_out<Out>(v0);
        if (gn + 1 < N) Cr[gn + 1] = to_out<Out>(v1);
      }
    }
  }
}

// the 2-D tensor map of a packed operand: rows (batch x M or N) of Kp bytes,
// a box of 128 rows x 128 bytes, 128-byte swizzle, zeros past the last row
int operand_map(CUtensorMap* map, const void* ptr, long long rows, int Kp) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (Kp % kBK || reinterpret_cast<uintptr_t>(ptr) % 16 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <typename Out>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, void* C, int batch,
           int M, int N, int Kp, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fp8_dot_sm90<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN), batch);
  fp8_dot_sm90<Out><<<grid, kThreads, kSmem, stream>>>(
      ta, tb, static_cast<Out*>(C), M, N, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (batch, M, Kp) and B (batch, N, Kp) float8_e4m3fn, contiguous, Kp a
// multiple of 128; C (batch, M, N) contiguous. out_dtype: 0 f32, 1 bf16,
// 2 f16. Returns the launch's CUDA error code (kEncodeError + a CUresult
// for a tensor map cuTensorMapEncodeTiled refused).
extern "C" int fp8_dot(const void* A, const void* B, void* C, int batch,
                       int M, int N, int Kp, int out_dtype, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap ta, tb;
  int err = operand_map(&ta, A, static_cast<long long>(batch) * M, Kp);
  if (!err) err = operand_map(&tb, B, static_cast<long long>(batch) * N, Kp);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch<float>(ta, tb, C, batch, M, N, Kp, st);
    case 1: return launch<__nv_bfloat16>(ta, tb, C, batch, M, N, Kp, st);
    case 2: return launch<__half>(ta, tb, C, batch, M, N, Kp, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
