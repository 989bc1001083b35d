// (e, m) round-to-nearest-even quantizers for NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU kernels of the reference package,
//   src/repro/kernels/quantize_em/kernel.py :: quantize_2d
//       (body _quantize_block)             -> quantize_em_static
//   src/repro/kernels/quantize_em/kernel.py :: quantize_2d_dynamic
//       (body _dyn_kernel -> ref.quantize_ref_dynamic, followed by
//        ops._bitflip)                     -> quantize_em_dynamic
//
// What bounds them on this card: bytes. Each element costs a few dozen
// integer/float instructions and two memory transactions, so the least time
// is (bytes read + bytes written) / memory bandwidth. The design therefore
// moves the fewest bytes it can:
//   * the kernels run over the flat contiguous array; there is no padding
//     to a (rows, 1024) tile and no slice copy afterwards;
//   * they read and write the storage type (f32, bf16, f16) directly:
//     widen in registers, round on the f32 carrier, narrow with
//     round-to-nearest-even on the store (2 * sizeof(storage) bytes per
//     element instead of three passes through an f32 copy);
//   * 16-byte vector loads/stores over the aligned body, a scalar tail, and
//     a scalar path for buffers that are not 16-byte aligned;
//   * the dynamic kernel reads its own (4,) int32 row from the format table
//     in device memory, derives every constant in registers and folds the
//     fault-channel XOR into the same pass: no host read of the table, no
//     second kernel.
//
// The contract is bit-exactness against the plain PyTorch versions in
// ../ref.py, so this file must be built WITHOUT --use_fast_math and with
// -ftz=false -prec-div=true -fmad=false: denormals must not flush on the
// subnormal branch, rintf is ties-to-even, the reciprocal of a power of two
// is exact, and no multiply-add may be contracted. The rounding itself
// (derive_row, quantize_one, the storage traits) lives in
// ../../csrc/quantize_em.cuh, shared with the fused epilogues of the
// flash-attention and WKV6 kernels.
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// given stream, never synchronises, never allocates, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include "quantize_em.cuh"   // derive_row, quantize_one, Storage<T>

namespace {

using repro_q::RowParams;
using repro_q::Storage;
using repro_q::derive_row;
using repro_q::quantize_one;

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

// grid-stride pass over the flat array. ``vec`` is set by the host when both
// buffers are 16-byte aligned: the body then moves one uint4 per thread and
// iteration, and the last n % kVec elements go through the scalar tail.
template <typename T>
__device__ __forceinline__ void quantize_pass(const T* __restrict__ in,
                                              T* __restrict__ out,
                                              long long n, int vec,
                                              const RowParams& p) {
  constexpr int V = Storage<T>::kVec;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  long long done = 0;
  if (vec) {
    const long long nvec = n / V;
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nvec; i += stride) {
      uint4 raw = in4[i];
      T* lane = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        Storage<T>::store(&lane[j],
                          quantize_one(Storage<T>::load(&lane[j]), p));
      }
      out4[i] = raw;
    }
    done = nvec * V;
  }
  for (long long i = done + tid; i < n; i += stride) {
    Storage<T>::store(&out[i], quantize_one(Storage<T>::load(&in[i]), p));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_static_kernel(const T* __restrict__ in, T* __restrict__ out,
                       long long n, int vec, RowParams p) {
  quantize_pass<T>(in, out, n, vec, p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_dynamic_kernel(const T* __restrict__ in, T* __restrict__ out,
                        long long n, int vec,
                        const int32_t* __restrict__ table, int site) {
  // every thread derives the same constants from the same 16 bytes: a few
  // dozen scalar instructions against thousands of bytes moved per thread
  const RowParams p = derive_row(table + 4 * (long long)site);
  quantize_pass<T>(in, out, n, vec, p);
}

int grid_for(long long n, int per_thread) {
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (sm_count <= 0) sm_count = 132;
  }
  const long long work = (n + per_thread - 1) / per_thread;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15u) == 0;
}

}  // namespace

// dtype codes shared with the python binding
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

// The host derives these once from the FPFormat; one binary serves every
// format. Field order is the ctypes.Structure's in ../kernel.py.
struct StaticParams {
  int32_t k;
  uint32_t half_m1;
  uint32_t keep;
  int32_t knz;
  int32_t use_sub;
  float ss;
  float ssinv;
  float min_normal;
  int32_t ovf_gate;
  float max_finite;
  int32_t ovf_mode;
};

extern "C" int quantize_em_static(const void* in, void* out, long long n,
                                  int dtype, StaticParams sp, void* stream) {
  if (n <= 0) return 0;
  RowParams p;
  p.k = sp.k; p.half_m1 = sp.half_m1; p.keep = sp.keep; p.knz = sp.knz;
  p.use_sub = sp.use_sub; p.ss = sp.ss; p.ssinv = sp.ssinv;
  p.min_normal = sp.min_normal; p.ovf_gate = sp.ovf_gate;
  p.max_finite = sp.max_finite; p.ovf_mode = sp.ovf_mode;
  p.identity = 0; p.fmask = 0u;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = aligned16(in, out) ? 1 : 0;
  switch (dtype) {
    case DT_F32:
      quantize_static_kernel<float>
          <<<grid_for(n, vec ? 4 : 1), kThreads, 0, s>>>(
              (const float*)in, (float*)out, n, vec, p);
      break;
    case DT_BF16:
      quantize_static_kernel<__nv_bfloat16>
          <<<grid_for(n, vec ? 8 : 1), kThreads, 0, s>>>(
              (const __nv_bfloat16*)in, (__nv_bfloat16*)out, n, vec, p);
      break;
    case DT_F16:
      quantize_static_kernel<__half>
          <<<grid_for(n, vec ? 8 : 1), kThreads, 0, s>>>(
              (const __half*)in, (__half*)out, n, vec, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int quantize_em_dynamic(const void* in, void* out, long long n,
                                   int dtype, const void* table, int site,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* t = (const int32_t*)table;
  const int vec = aligned16(in, out) ? 1 : 0;
  switch (dtype) {
    case DT_F32:
      quantize_dynamic_kernel<float>
          <<<grid_for(n, vec ? 4 : 1), kThreads, 0, s>>>(
              (const float*)in, (float*)out, n, vec, t, site);
      break;
    case DT_BF16:
      quantize_dynamic_kernel<__nv_bfloat16>
          <<<grid_for(n, vec ? 8 : 1), kThreads, 0, s>>>(
              (const __nv_bfloat16*)in, (__nv_bfloat16*)out, n, vec, t, site);
      break;
    case DT_F16:
      quantize_dynamic_kernel<__half>
          <<<grid_for(n, vec ? 8 : 1), kThreads, 0, s>>>(
              (const __half*)in, (__half*)out, n, vec, t, site);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
