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
// Decomposition:
//   * column j of the state evolves by itself, S[:, j] <- w * S[:, j] +
//     k v_j, and y_j = sum_i r_i S_ij + v_j b with b = sum_i r_i u_i k_i
//     (the bonus diag(u) k^T v has rank one). So a block holds JB = 16
//     columns of one head's state: the grid is (B*H, hd/JB), 256 blocks at
//     the main path's 1 x 64 heads x 64, enough for all 132 SMs;
//   * thread (g, c) of a block holds an R-row x JT-column register tile,
//     rows g*R .. g*R+R-1 (contiguous) and columns c*JT .. c*JT+JT-1; at
//     hd = 64 R = 4, JT = 2 (128 threads a block, two blocks an SM, two
//     warps a scheduler). Each token it reads r, k of its rows and v of its
//     columns in the storage type and w as f32 from shared memory in one
//     load each (8 / 8 / 4 / 16 bytes for bf16 r/k/v), widened in
//     registers; u of its rows stays in registers;
//   * per element and token four f32 instructions: k v, the fma of r with
//     S (y uses the state before the update), w * S, + k v. A thread's y
//     partials start at v_j * (its rows' share of b), then take the fma
//     chain over its rows in order;
//   * the G = hd/R lanes of a column group are neighbours in one warp; the
//     partials of U = G/JT tokens (U * JT = G values a lane) are summed
//     together with shuffles in a fixed tree: level l adds the values of
//     lanes g and g ^ 2^l, a lane sending half of the values it holds and
//     keeping the sum of the other half, so that each lane ends with one
//     sum and stores it through the quantizer's epilogue (15 shuffles for
//     8 tokens x 2 columns over 16 lanes, not 64). Each sum is the same
//     pairwise tree over the lanes in order, whichever lane takes it and
//     however the tokens are batched (a + b == b + a). A batch is summed
//     while the next one is computed (the shuffles wait on nothing the
//     arithmetic needs);
//   * chunks of C tokens of r, k, w (whole rows) and v (the block's
//     columns) stream into shared memory in their storage types with
//     16-byte cp.async copies, double-buffered: chunk c + 1 lands while
//     chunk c is computed, one barrier pair a chunk. The four column
//     blocks of a head copy the same r, k, w rows, from L2. The wrapper
//     hands over views whose base and strides are 16-byte multiples (it
//     copies any other); launch() caps C at what two stages fit.
//
// Exactness. The state update is elementwise, w*S then + k*v, each rounded
// (no fma): the same operations as the plain loop in ../ref.py, so sT is
// bit-equal to it, whatever the tile. ``chunk`` sets only the staging: the
// token order, the tile, the fma chains and the reduction tree do not
// depend on it, so y and sT are bitwise chunk-invariant; no atomics, so two
// launches are bit-equal.
//
// What bounds it on this card: instruction issue, and the latency that two
// warps a scheduler leave exposed. The function needs 5 hd^2 + 5 hd flop a
// token and head, 5.5 GFLOP at the main path's shape, 0.081 ms at the f32
// rate; without contracting w*S + kv (the contract above) the least it can
// issue is 4 f32 instructions a state element and token: 64 x 4096 x 4096
// x 4 / 32 = 134 M warp instructions, 0.128 ms on 132 SMs x 4 schedulers at
// 1.98 GHz. At hd = 64 and bf16 r/k/v this kernel's source asks ~64
// instructions a token and thread for 8 elements (32 the four per
// element, 10 the bonus and its fold into y, 10 widening bf16, ~8 the
// reduction, 4 shared loads), twice the floor's 32. Larger tiles issue
// fewer instructions an element but leave one warp or fewer a scheduler,
// smaller ones more of both; both measured slower (PERF.md).
//
// Not taken: the chunked matrix (tensor-core) form. It needs ratios of decay
// products within a chunk (64 decays multiply to ~1e-19 on the path's
// inputs, so the ratios leave the f32 range; the reference keeps the decay
// products implicit for that reason), its operands would be bf16 / TF32 so
// sT could not stay bit-equal to the plain loop, and the function is 5.5
// GFLOP: filling the SMs and issuing f32 work limit it, not the tensor rate.
//
// Build with the quantizer's flags (-ftz=false -prec-div=true
// -prec-sqrt=true -fmad=false): the epilogue is the quantizer's own device
// code (../../csrc/quantize_em.cuh).
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// never synchronises, never allocates, returns cudaGetLastError().

#include <algorithm>
#include <type_traits>

#include "quantize_em.cuh"

namespace {

using repro_q::RowParams;
using repro_q::derive_row;
using repro_q::store_epilogue;

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

// 16-byte asynchronous copies, global -> shared (sm_80+): nothing waits
// for them in registers, so a chunk's loads overlap the last chunk's work
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// n token rows of W values (a token stride of ts elements, 16-byte aligned
// rows) into shared memory rows of W, in the storage type
template <typename T, int W, int NT>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ts,
                                      int n, int tid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER = W / V;            // copies per token row
  for (int idx = tid; idx < n * PER; idx += NT) {
    const int t = idx / PER, q = idx - t * PER;
    cp_async16(dst + t * W + q * V, src + t * ts + q * V);
  }
}

// N consecutive values of shared memory (a multiple of 4 bytes, aligned to
// their size up to 16 bytes) in one to four loads, widened to f32 (bf16 ->
// f32 is exact: a shift)
template <typename T, int N>
__device__ __forceinline__ void lds(const T* p, float* out) {
  constexpr int WORDS = N * (int)sizeof(T) / 4;
  uint32_t u[WORDS];
  if constexpr (WORDS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < WORDS / 4; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[q];
      u[4 * q] = x.x; u[4 * q + 1] = x.y; u[4 * q + 2] = x.z;
      u[4 * q + 3] = x.w;
    }
  } else if constexpr (WORDS % 2 == 0) {
#pragma unroll
    for (int q = 0; q < WORDS / 2; ++q) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[q];
      u[2 * q] = x.x; u[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < WORDS; ++q)
      u[q] = reinterpret_cast<const uint32_t*>(p)[q];
  }
#pragma unroll
  for (int q = 0; q < WORDS; ++q) {
    if constexpr (sizeof(T) == 4) {
      out[q] = __uint_as_float(u[q]);
    } else {
      out[2 * q] = __uint_as_float(u[q] << 16);
      out[2 * q + 1] = __uint_as_float(u[q] & 0xFFFF0000u);
    }
  }
}

// Sum p[0..N) over the G lanes g of a column group (neighbouring lanes),
// level O adding lanes g and g ^ O. While N > 1 a lane keeps one half (the
// upper one if bit O of g is set) and sends the other to its partner. After
// the last level p[0 .. max(1, N / G)) holds the sums of values from
// sum_l bit_l(g) * N / 2^(l+1) on; a lane with g >= N holds a copy of lane
// g % N's. Whichever lane adds them, each sum is the same pairwise tree over
// the lanes in order (a + b == b + a): the values' batching does not change
// a bit of any sum.
template <int G, int N, int O = 1>
__device__ __forceinline__ void reduce_tree(float* p, int g, unsigned mask) {
  if constexpr (O < G) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool hi = (g & O) != 0;
#pragma unroll
      for (int q = 0; q < H; ++q) {
        const float send = hi ? p[q] : p[q + H];
        const float keep = hi ? p[q + H] : p[q];
        p[q] = __fadd_rn(keep, __shfl_xor_sync(mask, send, O));
      }
      reduce_tree<G, H, 2 * O>(p, g, mask);
    } else {
      p[0] = __fadd_rn(p[0], __shfl_xor_sync(mask, p[0], O));
      reduce_tree<G, 1, 2 * O>(p, g, mask);
    }
  }
}

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

template <typename TR, typename TW, int HD, int JB>
__host__ __device__ constexpr int stage_bytes(int chunk) {
  return chunk * (2 * HD * (int)sizeof(TR) + HD * (int)sizeof(TW)
                  + JB * (int)sizeof(TR));
}

template <typename TR, typename TW, int HD, int R, int JT, int JB>
__global__ void __launch_bounds__((HD / R) * (JB / JT))
wkv6_kernel(Args a) {
  constexpr int G = HD / R;             // lanes sharing a column group
  constexpr int NT = G * (JB / JT);     // threads
  constexpr int U = G > JT ? G / JT : 1;  // tokens a reduction batch
  constexpr unsigned kMask = NT >= 32 ? 0xFFFFFFFFu : (1u << (NT % 32)) - 1u;
  static_assert(R % 2 == 0 && JT % 2 == 0 && G <= 32 && (G & (G - 1)) == 0,
                "tile");
  extern __shared__ uint4 smem16[];
  const int C = a.chunk;
  char* const sbase = reinterpret_cast<char*>(smem16);
  const int sbytes = stage_bytes<TR, TW, HD, JB>(C);

  const int tid = threadIdx.x;
  const int g = tid % G, i0 = g * R;    // rows i0 .. i0 + R - 1
  const int jl = (tid / G) * JT;        // columns j0 + jl .. + JT - 1
  const int j0 = blockIdx.y * JB;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const long long bh = (long long)b * a.H + h;

  const TR* r = static_cast<const TR*>(a.r) + b * a.rs_b + h * a.rs_h;
  const TR* k = static_cast<const TR*>(a.k) + b * a.ks_b + h * a.ks_h;
  const TR* v = static_cast<const TR*>(a.v) + b * a.vs_b + h * a.vs_h + j0;
  const TW* w = static_cast<const TW*>(a.w) + b * a.ws_b + h * a.ws_h;
  float* y = a.y + bh * a.S * HD + j0;

  // stage s of the double buffer: r, k, w (C x HD), v (C x JB)
  auto rs = [&](int s) { return reinterpret_cast<TR*>(sbase + s * sbytes); };
  auto ks = [&](int s) { return rs(s) + C * HD; };
  auto ws = [&](int s) { return reinterpret_cast<TW*>(ks(s) + C * HD); };
  auto vs = [&](int s) { return reinterpret_cast<TR*>(ws(s) + C * HD); };
  auto issue = [&](int c0, int s) {
    const int n = min(C, a.S - c0);
    stage<TR, HD, NT>(rs(s), r + c0 * a.rs_s, a.rs_s, n, tid);
    stage<TR, HD, NT>(ks(s), k + c0 * a.ks_s, a.ks_s, n, tid);
    stage<TW, HD, NT>(ws(s), w + c0 * a.ws_s, a.ws_s, n, tid);
    stage<TR, JB, NT>(vs(s), v + c0 * a.vs_s, a.vs_s, n, tid);
  };

  float st[R][JT], u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    u[i] = a.u[h * HD + i0 + i];
#pragma unroll
    for (int c = 0; c < JT; ++c)
      st[i][c] = a.s0[(bh * HD + i0 + i) * HD + j0 + jl + c];
  }

  const bool fused = a.row != nullptr;
  RowParams prm = {};
  if (fused) prm = derive_row(a.row);

  // UU tokens from t on, out of stage s: the state steps token by token,
  // and p gets the UU x JT y partials of this lane
  auto advance = [&](auto uu_count, float* p, int s, int t) {
    constexpr int UU = decltype(uu_count)::value;
#pragma unroll
    for (int q = 0; q < UU; ++q) {
      const int tt = t + q;
      float rr[R], kk[R], ww[R], vv[JT];
      lds<TR, R>(rs(s) + tt * HD + i0, rr);
      lds<TR, R>(ks(s) + tt * HD + i0, kk);
      lds<TW, R>(ws(s) + tt * HD + i0, ww);
      lds<TR, JT>(vs(s) + tt * JB + jl, vv);
      float bp = 0.0f;                  // this lane's share of b
#pragma unroll
      for (int i = 0; i < R; ++i)
        bp = __fmaf_rn(__fmul_rn(rr[i], u[i]), kk[i], bp);
      float* pq = p + q * JT;
#pragma unroll
      for (int c = 0; c < JT; ++c) pq[c] = __fmul_rn(vv[c], bp);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < JT; ++c) {
          const float kv = __fmul_rn(kk[i], vv[c]);
          // y uses the state before this token's update
          pq[c] = __fmaf_rn(rr[i], st[i][c], pq[c]);
          st[i][c] = __fadd_rn(__fmul_rn(ww[i], st[i][c]), kv);
        }
      }
    }
  };
  // the UU x JT partials of tokens t0 .. t0 + UU - 1 summed over the lanes
  // and stored by the lanes that end up holding them
  auto flush = [&](auto uu_count, float* p, long long t0) {
    constexpr int N = decltype(uu_count)::value * JT;
    constexpr int L = ilog2(N < G ? N : G);     // halving levels
    constexpr int NF = N >> L;                   // sums a lane holds
    reduce_tree<G, N>(p, g, kMask);
    if ((g >> L) == 0) {
      int first = 0;                    // the first value this lane holds
#pragma unroll
      for (int l = 0; l < L; ++l) first += ((g >> l) & 1) * (N >> (l + 1));
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int q = (first + f) / JT, c = (first + f) % JT;
        store_epilogue<float>(y + (t0 + q) * HD + jl + c, p[f], fused, prm);
      }
    }
  };
  using Batch = std::integral_constant<int, U>;
  using One = std::integral_constant<int, 1>;

  issue(0, 0);
  cp_async_commit();
  int s = 0;
  for (int c0 = 0; c0 < a.S; c0 += C, s ^= 1) {
    const int n = min(C, a.S - c0);
    // the next chunk streams into the other stage, which every thread
    // finished reading before the barrier that ended the last chunk
    if (c0 + C < a.S) issue(c0 + C, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                 // this chunk's copies have landed
    __syncthreads();
    // batches of U tokens, each batch's sums taken while the next one is
    // computed (their shuffles wait on nothing the arithmetic needs), then
    // the tokens left one by one
    int t = 0;
    if (n >= U) {
      float pa[U * JT], pb[U * JT];
      advance(Batch{}, pa, s, 0);
      for (t = U; t + 2 * U <= n; t += 2 * U) {
        advance(Batch{}, pb, s, t);
        flush(Batch{}, pa, c0 + t - U);
        advance(Batch{}, pa, s, t + U);
        flush(Batch{}, pb, c0 + t);
      }
      if (t + U <= n) {
        advance(Batch{}, pb, s, t);
        flush(Batch{}, pa, c0 + t - U);
        flush(Batch{}, pb, c0 + t);
        t += U;
      } else {
        flush(Batch{}, pa, c0 + t - U);
      }
    }
    for (; t < n; ++t) {
      float p[JT];
      advance(One{}, p, s, t);
      flush(One{}, p, c0 + t);
    }
    __syncthreads();                    // stage s is free again
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < JT; ++c)
      a.sT[(bh * HD + i0 + i) * HD + j0 + jl + c] = st[i][c];
  }
}

template <typename TR, typename TW, int HD, int R, int JT, int JB>
int launch(Args a, int B, cudaStream_t stream) {
  // the tokens staged at a time: chunk, at least 1, at most S, and no more
  // than two stages fit in a block's shared memory (no result depends on it)
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  a.chunk = std::max(1, std::min({a.chunk, a.S,
                                  optin / stage_bytes<TR, TW, HD, JB>(2)}));
  const size_t smem = 2 * (size_t)stage_bytes<TR, TW, HD, JB>(a.chunk);
  err = cudaFuncSetAttribute(
      wkv6_kernel<TR, TW, HD, R, JT, JB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<TR, TW, HD, R, JT, JB>
      <<<dim3(B * a.H, HD / JB), (HD / R) * (JB / JT), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One tile per head dim: R rows x JT columns a thread, JB columns a block
template <typename TR, typename TW>
int launch_hd(const Args& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<TR, TW, 8, 4, 2, 8>(a, B, stream);
    case 16: return launch<TR, TW, 16, 4, 2, 16>(a, B, stream);
    case 32: return launch<TR, TW, 32, 4, 4, 16>(a, B, stream);
    case 64: return launch<TR, TW, 64, 4, 2, 16>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with the python binding
enum { DT_F32 = 0, DT_BF16 = 1 };

// r, k, v (B, H, S, hd) of dtype rkv_dtype and w (B, H, S, hd) of dtype
// w_dtype, unit stride on the last axis, 16-byte aligned bases and the given
// strides (in elements, multiples of 16 bytes) on the others; u (H, hd),
// s0 (B, H, hd, hd), y (B, H, S, hd) and sT (B, H, hd, hd) contiguous f32.
// row: a (4,) int32 format row in device memory, or null for no epilogue.
// chunk: the tokens staged at a time (at least 1, capped at S and at what
// two stages fit).
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
