// Native fp8 (e4m3) dot with f32 accumulation: the execution path of
// `truncate(..., native_fp8=True)` for `quantize_dot_inputs` dot sites.
//
// Replaces: src/repro/kernels/fp8_dot.py::fp8_dot_general (the reference's
// `lax.dot_general` on float8_e4m3fn operands with
// preferred_element_type=f32; not a Pallas kernel, XLA's dot).
//
// C[b, m, n] = sum_k A[b, m, k] * B[b, k, n], A and B float8_e4m3fn
// (one byte each, any strides), C contiguous (batch, M, N) in f32, bf16 or
// f16, rounded once from the f32 sum.
//
// Bound on this card: operations. At h2o-danube-1.8b's MLP shapes
// (8192 x 2560 x 13824) the 580 GFLOP take 0.29 ms at the fp8 tensor-core
// rate against 0.08 ms for the bytes. This first kernel is the simple,
// exact one: products of two e4m3 values are exact in f32 (4 x 4
// significant bits), so each fmaf rounds only the running sum, in k order,
// and the result is within K * 2^-24 * sum|a b| of the exact dot, as an f32
// reference matmul is. It runs on the CUDA cores: a 128 x 128 output tile
// per block of 256 threads, each thread an 8 x 8 register tile (rows and
// columns 16 apart, so the shared-memory reads of a warp hit distinct
// banks), k in steps of 32 through shared memory, operands decoded from
// fp8 through a 256-entry table on the way in. The tensor cores' fp8 path
// (wgmma, TMA) is a later design: their fp8 accumulation is not plain f32.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, TM = 8, TN = 8, THREADS = 256;

// e4m3fn: s eeee mmm, bias 7, subnormals at e = 0, no inf, NaN = s1111111
__device__ float decode_e4m3(unsigned v) {
    const unsigned e = (v >> 3) & 0xF, m = v & 0x7;
    float mag;
    if (e == 0xF && m == 0x7) {
        mag = __int_as_float(0x7FC00000);
    } else if (e == 0) {
        mag = ldexpf(static_cast<float>(m), -9);
    } else {
        mag = ldexpf(static_cast<float>(8 + m), static_cast<int>(e) - 10);
    }
    return (v & 0x80) ? -mag : mag;
}

template <typename Out> __device__ Out to_out(float x);
template <> __device__ float to_out<float>(float x) { return x; }
template <> __device__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}
template <> __device__ __half to_out<__half>(float x) {
    return __float2half_rn(x);
}

template <typename Out>
__global__ void __launch_bounds__(THREADS)
fp8_dot_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
               Out* __restrict__ C, int M, int N, int K,
               long long sab, long long sam, long long sak,
               long long sbb, long long sbk, long long sbn) {
    __shared__ float lut[256];
    __shared__ float As[BK][BM + 1];
    __shared__ float Bs[BK][BN + 1];
    const int tid = threadIdx.x;
    lut[tid] = decode_e4m3(static_cast<unsigned>(tid));

    const long long b = blockIdx.z;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const uint8_t* Ab = A + b * sab;
    const uint8_t* Bb = B + b * sbb;
    const int tr = tid / 16, tc = tid % 16;
    // neighbouring threads on neighbouring bytes where the layout allows
    const bool a_k_inner = sak == 1, b_n_inner = sbn == 1 || sbk != 1;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    __syncthreads();

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = tid; i < BM * BK; i += THREADS) {
            const int mm = a_k_inner ? i / BK : i % BM;
            const int kk = a_k_inner ? i % BK : i / BM;
            const int gm = m0 + mm, gk = k0 + kk;
            As[kk][mm] = (gm < M && gk < K)
                ? lut[Ab[gm * sam + gk * sak]] : 0.f;
        }
        for (int i = tid; i < BN * BK; i += THREADS) {
            const int nn = b_n_inner ? i % BN : i / BK;
            const int kk = b_n_inner ? i / BN : i % BK;
            const int gn = n0 + nn, gk = k0 + kk;
            Bs[kk][nn] = (gn < N && gk < K)
                ? lut[Bb[gk * sbk + gn * sbn]] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][tr + 16 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tc + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

    Out* Cb = C + b * static_cast<long long>(M) * N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gm = m0 + tr + 16 * i;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gn = n0 + tc + 16 * j;
            if (gn < N)
                Cb[static_cast<long long>(gm) * N + gn] = to_out<Out>(acc[i][j]);
        }
    }
}

template <typename Out>
int launch(const void* A, const void* B, void* C, int batch, int M, int N,
           int K, const long long* s, cudaStream_t stream) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
    fp8_dot_kernel<Out><<<grid, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(B),
        static_cast<Out*>(C), M, N, K, s[0], s[1], s[2], s[3], s[4], s[5]);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides (in elements = bytes): A (batch, m, k), B (batch, k, n).
// out_dtype: 0 f32, 1 bf16, 2 f16. Returns the launch's CUDA error code.
extern "C" int fp8_dot(const void* A, const void* B, void* C, int batch,
                       int M, int N, int K, long long sab, long long sam,
                       long long sak, long long sbb, long long sbk,
                       long long sbn, int out_dtype, void* stream) {
    if (batch > 65535 || (M + BM - 1) / BM > 65535)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long s[6] = {sab, sam, sak, sbb, sbk, sbn};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (out_dtype) {
        case 0: return launch<float>(A, B, C, batch, M, N, K, s, st);
        case 1: return launch<__nv_bfloat16>(A, B, C, batch, M, N, K, s, st);
        case 2: return launch<__half>(A, B, C, batch, M, N, K, s, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
