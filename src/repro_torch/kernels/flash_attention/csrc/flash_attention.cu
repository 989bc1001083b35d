// Blockwise-softmax attention (grouped-query, causal and/or sliding window)
// for NVIDIA Hopper (sm_90a), with the dynamic (e, m) quantize as an
// optional epilogue on the stored output.
//
// Replaces the TPU kernel of the reference package
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_pallas
//       (body _attn_kernel)                   -> flash_attention_fwd
// It computes what _attn_kernel computes -- running (max, denominator,
// accumulator) over KV blocks in f32, the -1e30 mask constant, output cast
// to q's dtype, then the row's quantize on the stored value -- with two
// kernels behind the one entry point:
//
//   bf16 inputs -> flash_fwd_bf16_sm90 (flash_attention_sm90.cuh), on the
//                  tensor cores;
//   f32 inputs  -> flash_fwd_kernel below, exact f32 on the CUDA cores (the
//                  reference's f32 tolerance, 2e-5, rules out TF32).
//
// What bounds it on this card: operations. At the fused path's shape
// (1 x 32 q heads x 8192 x 80, 8 KV heads, causal, window 4096) the
// unmasked (q, k) pairs need 257.7 GFLOP: 0.261 ms at 989 TFLOP/s bf16, or
// 3.85 ms at 67 TFLOP/s f32; ~0.8 G exponentials (~0.2 ms on the
// special-function units); the bytes (~105 MB) take 0.03 ms.
//
// The bf16 kernel. The f32-computed plain version is the yardstick: the
// output must stay within 2 bf16 units (+1e-6) of it, and an output near
// zero has a tiny unit, so the kernel has to be good to ~1e-6 absolute.
// Two things stand in the way, and the design pays for both:
//   * P rounded once to bf16 before P V is off by ~3e-5 absolute; split in
//     two bf16 terms it is still off by up to 2^-16 per term, which shows in
//     rows with few keys. P = P_hi + P_mid + P_lo (each bf16, the
//     differences exact) is p within 2^-24, and P V is three tensor-core
//     products: 2x the single-rounding design's work, 640 flop per
//     unmasked pair at D = Dv = 80 (0.52 ms at the peak rate);
//   * the tensor cores' f32 sums lose ~2^-23 of the accumulator's
//     magnitude a step, and a 4096-key row takes ~770 steps into one
//     accumulator. Each tile's P V goes into a fresh accumulator (12 steps,
//     the small terms first), and O = O * corr + T is summed in f32 on the
//     CUDA cores.
// The scale multiplies S in f32 after the product (q * scale is not
// bf16-exact), folded with log2(e) into one constant for ex2; l sums the
// f32 p. Against what held the CUDA-core kernel back:
//
//   * products on the CUDA cores: S = Q K^T and P V are wgmma with bf16
//     operands and f32 accumulators (Q and K from shared memory, P from
//     registers straight from the S accumulator's layout);
//   * one shared-memory load per two FMAs: wgmma reads its shared-memory
//     operands itself, at tile granularity;
//   * synchronous K/V loads, three barriers a tile: one thread streams K/V
//     tiles by TMA into a 4-stage ring (mbarriers), straight from the
//     strided (B, S, H, D) views, Q once per block, and no thread waits for
//     a copy it did not need; the softmax of tile i+1 runs while the P V
//     product of tile i is on the tensor cores;
//   * K/V fetched once per q head: a block is 128 rows of one q head (two
//     warpgroups share every tile), and the q heads of one KV head are
//     neighbours in the grid, so they read its tiles from L2 together.
//
// Only tiles that cross the diagonal, the window's edge or S compute the
// mask. Tiles wholly above the diagonal or below the window are skipped in
// both kernels, and that is exact: in the reference such a leading block is
// fully masked, gives p = exp(-1e30 - (-1e30)) = 1 only while the row's
// running max is still -1e30, and the first block with an unmasked key
// multiplies that state by corr = exp(-1e30 - m) = 0, which is the state a
// skipped block leaves (m = -1e30, l = 0, acc = 0). Any S: keys at or past S
// are masked like the rest, rows at or past S are computed on zeros and not
// stored (the reference's S % block == 0 is a TPU tiling need).
//
// The f32 kernel (flash_fwd_kernel, f32 inputs only): one block owns BQ = 64
// query rows of one q head and reads K/V of its KV head h / (Hq / Hkv),
// staged through shared memory in tiles of BK = 64 keys; 256 threads as
// 16 x 16, thread (ty, tx) owns rows ty*4 .. ty*4+3 and key columns
// tx + 16 j (scores) / value columns tx + 16 j (output); a row's max and sum
// are reduced over its 16 lanes with shuffles, in a fixed order. It cannot
// go under the f32 floor of 3.85 ms.
//
// Determinism: no atomics, one fixed reduction order in both kernels, so the
// same inputs give the same bits on every run -- which "fused == unfused
// followed by quantize_em_dynamic, bit for bit" needs.
//
// Build with the quantizer's flags (-ftz=false -prec-div=true
// -prec-sqrt=true -fmad=false): the epilogue is the quantizer's own device
// code (../../csrc/quantize_em.cuh) and must not be contracted; the
// attention math writes its fmas out as __fmaf_rn.
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// never synchronises, never allocates, returns cudaGetLastError() (or the
// CUresult of a refused tensor map plus 10000).

#include "quantize_em.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using repro_q::RowParams;
using repro_q::Storage;
using repro_q::derive_row;
using repro_q::store_epilogue;

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per staged tile
constexpr int kTX = 16, kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRQ = kBQ / kTY;          // rows per thread
constexpr int kCK = kBK / kTX;          // key columns per thread
constexpr int kPP = kBK + 1;            // padded row of the P tile
constexpr float kNegInf = -1e30f;       // the reference's mask constant

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int32_t* row;                   // nullptr: no epilogue
  long long qs_b, qs_h, qs_s;           // strides in elements; last dim 1
  long long ks_b, ks_h, ks_s;
  long long vs_b, vs_h, vs_s;
  int Hq, Hkv, S, D;
  int causal, window;                   // window <= 0: no window
  float scale;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Args a) {
  constexpr int DV = 16 * NJ;
  extern __shared__ float smem[];
  const int D = a.D;
  const int Dp = D + 1;                 // odd stride: no bank conflicts
  float* Qs = smem;                     // kBQ x Dp, scaled
  float* Ks = Qs + kBQ * Dp;            // kBK x Dp
  float* Vs = Ks + kBK * Dp;            // kBK x DV
  float* Ps = Vs + kBK * DV;            // kBQ x kPP

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int S = a.S;

  const T* q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks_b + hk * a.ks_h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs_b + hk * a.vs_h;

  // q is scaled before the product, as the reference's kernel does
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int qi = q0 + r;
    Qs[r * Dp + c] = qi < S
        ? __fmul_rn(Storage<T>::load(q + qi * a.qs_s + c), a.scale) : 0.0f;
  }

  // keys this block can see: below the diagonal (causal), inside the window
  int key_lo = 0, key_hi = S;
  if (a.causal) key_hi = min(S, q0 + kBQ);
  if (a.window > 0) key_lo = max(0, q0 - a.window + 1);
  const int kb_lo = key_lo / kBK;
  const int kb_hi = (key_hi + kBK - 1) / kBK;

  float m[kRQ], l[kRQ], acc[kRQ][NJ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                    // the last tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      const int kj = k0 + r;
      Ks[r * Dp + c] = kj < S ? Storage<T>::load(k + kj * a.ks_s + c) : 0.0f;
    }
    for (int idx = tid; idx < kBK * DV; idx += kThreads) {
      const int r = idx / DV, c = idx - r * DV;
      const int kj = k0 + r;
      Vs[r * DV + c] = kj < S ? Storage<T>::load(v + kj * a.vs_s + c) : 0.0f;
    }
    __syncthreads();

    // scores of this thread's 4 x 4 (row, key) pairs
    float s[kRQ][kCK];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kCK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qf[kRQ], kf[kCK];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) qf[i] = Qs[(ty * kRQ + i) * Dp + d];
#pragma unroll
      for (int j = 0; j < kCK; ++j) kf[j] = Ks[(tx + kTX * j) * Dp + d];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < kCK; ++j)
          s[i][j] = __fmaf_rn(qf[i], kf[j], s[i][j]);
    }

    // mask, running max, probabilities, running denominator
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      const int qi = q0 + ty * kRQ + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCK; ++j) {
        const int kj = k0 + tx + kTX * j;
        const bool ok = kj < S && (!a.causal || qi >= kj) &&
                        (a.window <= 0 || qi - kj < a.window);
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCK; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        Ps[(ty * kRQ + i) * kPP + tx + kTX * j] = p;
        rs = __fadd_rn(rs, p);
      }
      const float corr = expf(__fsub_rn(m[i], m_new));
      l[i] = __fmaf_rn(l[i], corr, row_sum16(rs));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = __fmul_rn(acc[i][j], corr);
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pf[kRQ], vf[NJ];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) pf[i] = Ps[(ty * kRQ + i) * kPP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vf[j] = Vs[kk * DV + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = __fmaf_rn(pf[i], vf[j], acc[i][j]);
    }
  }

  // epilogue: normalise, store in q's dtype, the row's quantize if wired in
  const bool fused = a.row != nullptr;
  RowParams prm = {};
  if (fused) prm = derive_row(a.row);
  T* out = static_cast<T*>(a.out) + ((long long)b * a.Hq + h) * S * DV;
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int qi = q0 + ty * kRQ + i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store_epilogue<T>(out + (long long)qi * DV + tx + kTX * j,
                        __fdiv_rn(acc[i][j], denom), fused, prm);
  }
}

template <typename T, int NJ>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(kBQ + kBK) * (a.D + 1) + (size_t)kBK * 16 * NJ +
       (size_t)kBQ * kPP);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.Hq, B);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dv(const Args& a, int B, int Dv, cudaStream_t stream) {
  switch (Dv) {
    case 16: return launch<T, 1>(a, B, stream);
    case 32: return launch<T, 2>(a, B, stream);
    case 64: return launch<T, 4>(a, B, stream);
    case 80: return launch<T, 5>(a, B, stream);
    case 128: return launch<T, 8>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with the python binding
enum { DT_F32 = 0, DT_BF16 = 1 };

// q (B, Hq, S, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv) with unit stride on
// the last axis and the given strides (in elements) on the others; out
// (B, Hq, S, Dv) contiguous, q's dtype. row: a (4,) int32 format row in
// device memory, or null for no epilogue. window <= 0: no window. bf16 also
// needs what flash_fwd_bf16 states (D a multiple of 16; k, v in TMA's
// terms); the binding makes the copy that gives it that.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const void* row,
    long long qs_b, long long qs_h, long long qs_s,
    long long ks_b, long long ks_h, long long ks_s,
    long long vs_b, long long vs_h, long long vs_s,
    int B, int Hq, int Hkv, int S, int D, int Dv,
    int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D <= 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return fa_sm90::flash_fwd_bf16(q, k, v, out, row, qs_b, qs_h, qs_s, ks_b,
                                   ks_h, ks_s, vs_b, vs_h, vs_s, B, Hq, Hkv,
                                   S, D, Dv, causal, window, scale, s);
  if (dtype != DT_F32) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.row = static_cast<const int32_t*>(row);
  a.qs_b = qs_b; a.qs_h = qs_h; a.qs_s = qs_s;
  a.ks_b = ks_b; a.ks_h = ks_h; a.ks_s = ks_s;
  a.vs_b = vs_b; a.vs_h = vs_h; a.vs_s = vs_s;
  a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.D = D;
  a.causal = causal; a.window = window; a.scale = scale;
  return launch_dv<float>(a, B, Dv, s);
}
