// RWKV-6 (Finch) WKV recurrence for NVIDIA Hopper (sm_90a), with the
// dynamic (e, m) quantize as an optional epilogue on y.
//
// Replaces the TPU kernel of the reference package
//   src/repro/kernels/rwkv6/kernel.py :: wkv6_pallas
//       (body _wkv_kernel)                    -> wkv6_fwd
// Per (batch, head), with per-token, per-channel decay w_t in (0, 1):
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)        (y_t uses S_{t-1})
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
// y is f32 whatever the inputs (the reference's out_shape); the epilogue
// applies to y only and the final state sT is stored exact.
//
// Design:
//   * one block per (batch, head); the hd x hd f32 state lives in
//     registers: thread (j, s) of hd x 4 threads (256 at hd = 64) holds
//     column j, rows s, s+4, s+8, ... (hd/4 values). y_t[j] is the sum of
//     the four row slices' partial sums, reduced over four neighbouring
//     lanes with two shuffles in a fixed order -- no __syncthreads per
//     token;
//   * a chunk of C tokens of r, k, v, w is staged through shared memory,
//     widened to f32 (one barrier pair per chunk). ``chunk`` sets only this
//     staging: the token order and every operation are the same for every
//     chunk, so results are bitwise chunk-invariant;
//   * the state update is elementwise, w*S then + k*v, each rounded (no
//     fma): the same operations as the plain loop in ../ref.py, so sT is
//     bit-equal to it on the same inputs.
//
// What bounds it on this card: latency. The function needs 5 hd^2 + 5 hd
// flop per token and head (r S, w * S, k^T v and the sum; the bonus term
// has rank one, v_j * sum_i r_i u_i k_i): 5.5 GFLOP at the main path's
// 1 x 64 heads x 4096 x 64, 0.08 ms at the f32 rate, and ~237 MB of bytes
// (0.07 ms). This kernel does 7 hd^2 (it adds u_i k_i v_j into every (i, j)
// term of y), but each head is a chain of S sequential steps, and at B = 1
// only 64 blocks run on 132 SMs: the time is S times the latency of one step
// (shared-memory loads, a dependent chain of hd/4 fmas, two shuffles), and
// the extra multiply-add sits off that chain. The chunked matrix form of the
// recurrence, which turns most of the work into products over a chunk, is
// later work.
//
// Build with the quantizer's flags (-ftz=false -prec-div=true
// -prec-sqrt=true -fmad=false): the epilogue is the quantizer's own device
// code (../../csrc/quantize_em.cuh).
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// never synchronises, never allocates, returns cudaGetLastError().

#include "quantize_em.cuh"

namespace {

using repro_q::RowParams;
using repro_q::Storage;
using repro_q::derive_row;
using repro_q::store_epilogue;

constexpr int kSlices = 4;              // row slices per state column

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;                       // (H, hd) contiguous
  const float* s0;                      // (B, H, hd, hd) contiguous
  float* y;                             // (B, H, S, hd) contiguous
  float* sT;                            // (B, H, hd, hd) contiguous
  const int32_t* row;                   // nullptr: no epilogue
  long long rs_b, rs_h, rs_s;           // strides in elements; last dim 1
  long long ks_b, ks_h, ks_s;
  long long vs_b, vs_h, vs_s;
  long long ws_b, ws_h, ws_s;
  int H, S, chunk;
};

template <typename TR, typename TW, int HD>
__global__ void __launch_bounds__(HD * kSlices)
wkv6_kernel(Args a) {
  constexpr int kRows = HD / kSlices;   // state rows per thread
  constexpr int kThreads = HD * kSlices;
  extern __shared__ float smem[];
  const int C = a.chunk;
  float* rs = smem;                     // C x HD each
  float* ks = rs + C * HD;
  float* vs = ks + C * HD;
  float* ws = vs + C * HD;

  const int tid = threadIdx.x;
  const int j = tid / kSlices;          // state column
  const int sl = tid % kSlices;         // rows sl, sl + 4, ...
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const long long bh = (long long)b * a.H + h;

  const TR* r = static_cast<const TR*>(a.r) + b * a.rs_b + h * a.rs_h;
  const TR* k = static_cast<const TR*>(a.k) + b * a.ks_b + h * a.ks_h;
  const TR* v = static_cast<const TR*>(a.v) + b * a.vs_b + h * a.vs_h;
  const TW* w = static_cast<const TW*>(a.w) + b * a.ws_b + h * a.ws_h;
  float* y = a.y + bh * a.S * HD;

  float st[kRows], u[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int i = sl + kSlices * ii;
    u[ii] = a.u[h * HD + i];
    st[ii] = a.s0[(bh * HD + i) * HD + j];
  }

  const bool fused = a.row != nullptr;
  RowParams prm = {};
  if (fused) prm = derive_row(a.row);

  for (int c0 = 0; c0 < a.S; c0 += C) {
    const int n = min(C, a.S - c0);
    __syncthreads();                    // the last chunk's readers are done
    for (int idx = tid; idx < n * HD; idx += kThreads) {
      const int t = idx / HD, d = idx - t * HD;
      const long long tt = c0 + t;
      rs[idx] = Storage<TR>::load(r + tt * a.rs_s + d);
      ks[idx] = Storage<TR>::load(k + tt * a.ks_s + d);
      vs[idx] = Storage<TR>::load(v + tt * a.vs_s + d);
      ws[idx] = Storage<TW>::load(w + tt * a.ws_s + d);
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float* rt = rs + t * HD;
      const float* kt = ks + t * HD;
      const float* wt = ws + t * HD;
      const float vj = vs[t * HD + j];
      float part = 0.0f;
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const int i = sl + kSlices * ii;
        const float kv = __fmul_rn(kt[i], vj);
        // y uses the state before this token's update
        part = __fmaf_rn(rt[i], __fadd_rn(st[ii], __fmul_rn(u[ii], kv)),
                         part);
        st[ii] = __fadd_rn(__fmul_rn(wt[i], st[ii]), kv);
      }
      // sum of the four slices, in the same order on every lane
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 1));
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 2));
      if (sl == 0) store_epilogue<float>(y + (c0 + t) * (long long)HD + j,
                                         part, fused, prm);
    }
  }

#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int i = sl + kSlices * ii;
    a.sT[(bh * HD + i) * HD + j] = st[ii];
  }
}

template <typename TR, typename TW, int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * (size_t)a.chunk * HD;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<TR, TW, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<TR, TW, HD><<<B * a.H, HD * kSlices, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TR, typename TW>
int launch_hd(const Args& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<TR, TW, 8>(a, B, stream);
    case 16: return launch<TR, TW, 16>(a, B, stream);
    case 32: return launch<TR, TW, 32>(a, B, stream);
    case 64: return launch<TR, TW, 64>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with the python binding
enum { DT_F32 = 0, DT_BF16 = 1 };

// r, k, v (B, H, S, hd) of dtype rkv_dtype and w (B, H, S, hd) of dtype
// w_dtype, unit stride on the last axis and the given strides (in elements)
// on the others; u (H, hd), s0 (B, H, hd, hd), y (B, H, S, hd) and
// sT (B, H, hd, hd) contiguous f32. row: a (4,) int32 format row in device
// memory, or null for no epilogue.
extern "C" int wkv6_fwd(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* y, void* sT, const void* row,
    long long rs_b, long long rs_h, long long rs_s,
    long long ks_b, long long ks_h, long long ks_s,
    long long vs_b, long long vs_h, long long vs_s,
    long long ws_b, long long ws_h, long long ws_s,
    int B, int H, int S, int hd, int chunk, int rkv_dtype, int w_dtype,
    void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r; a.k = k; a.v = v; a.w = w;
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.y = static_cast<float*>(y);
  a.sT = static_cast<float*>(sT);
  a.row = static_cast<const int32_t*>(row);
  a.rs_b = rs_b; a.rs_h = rs_h; a.rs_s = rs_s;
  a.ks_b = ks_b; a.ks_h = ks_h; a.ks_s = ks_s;
  a.vs_b = vs_b; a.vs_h = vs_h; a.vs_s = vs_s;
  a.ws_b = ws_b; a.ws_h = ws_h; a.ws_s = ws_s;
  a.H = H; a.S = S; a.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rkv_dtype == DT_F32 && w_dtype == DT_F32)
    return launch_hd<float, float>(a, B, hd, s);
  if (rkv_dtype == DT_BF16 && w_dtype == DT_F32)
    return launch_hd<__nv_bfloat16, float>(a, B, hd, s);
  if (rkv_dtype == DT_BF16 && w_dtype == DT_BF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(a, B, hd, s);
  if (rkv_dtype == DT_F32 && w_dtype == DT_BF16)
    return launch_hd<float, __nv_bfloat16>(a, B, hd, s);
  return (int)cudaErrorInvalidValue;
}
