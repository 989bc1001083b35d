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
// is exact, and no multiply-add may be contracted.
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// given stream, never synchronises, never allocates, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr uint32_t kQuietNaN = 0x7FC00000u;   // the positive quiet NaN
constexpr uint32_t kInfBits = 0x7F800000u;
constexpr uint32_t kAbsMask = 0x7FFFFFFFu;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

// ---------------------------------------------------------------------------
// rounding constants: one struct serves both kernels
// ---------------------------------------------------------------------------

struct RowParams {
  int32_t k;            // carrier mantissa bits to drop, 0..23
  uint32_t half_m1;     // (1 << (k-1)) - 1, 0 when k == 0
  uint32_t keep;        // ~((1 << k) - 1)
  int32_t knz;          // k > 0
  int32_t use_sub;      // subnormal branch live
  float ss;             // subnormal spacing (power of two), 1 when gated off
  float ssinv;          // exact reciprocal of ss
  float min_normal;
  int32_t ovf_gate;     // max_finite fits the carrier
  float max_finite;
  int32_t ovf_mode;     // 0 saturate, 1 +/-inf, 2 positive quiet NaN
  int32_t identity;     // return x unchanged
  uint32_t fmask;       // fault-channel XOR mask, 0 = no-op
};

// exact 2**n by writing the exponent field; clips to 0 below the normal
// range and to +inf above it, as the plain version's _pow2 does
__device__ __forceinline__ float pow2_clip(int n) {
  int biased = n + 127;
  biased = biased < 0 ? 0 : (biased > 255 ? 255 : biased);
  return __int_as_float(biased << 23);
}

// shift of a 32-bit one that is defined for every amount: >= 32 gives 0
__device__ __forceinline__ uint32_t shl_one(int s) {
  return (s >= 0 && s < 32) ? (1u << s) : 0u;
}

// the four fields of a table row -> rounding constants, mirroring
// dynamic_row_params of ../ref.py operation for operation
__device__ __forceinline__ RowParams derive_row(const int32_t* row) {
  const int e = row[0], m = row[1];
  const bool sat = row[2] != 0;
  const int f3 = row[3];
  const bool inf = (f3 & 1) != 0;
  const int fault = f3 >> 1;

  const int bias = (int)shl_one(e - 1) - 1;
  const int max_exp = (int)shl_one(e) - (inf ? 2 : 1) - bias;
  const int min_exp = 1 - bias;
  const int m_eff = m < 23 ? m : 23;
  const float max_finite =
      pow2_clip(max_exp) * (2.0f - pow2_clip(inf ? -m_eff : 1 - m_eff));
  const float min_normal = pow2_clip(min_exp);
  const float sub_scale = pow2_clip(min_exp - m);

  int k = 23 - m;
  k = k < 0 ? 0 : (k > 23 ? 23 : k);

  RowParams p;
  p.k = k;
  p.half_m1 = shl_one(k > 0 ? k - 1 : 0) - 1u;
  p.keep = ~(shl_one(k) - 1u);
  p.knz = k > 0;
  p.use_sub = (e < 8) && (sub_scale >= 1.17549435e-38f);   // f32 tiny
  p.ss = p.use_sub ? sub_scale : 1.0f;
  p.ssinv = p.use_sub ? 1.0f / p.ss : 1.0f;
  p.min_normal = min_normal;
  p.ovf_gate = max_finite <= 3.40282347e+38f;              // f32 max
  p.max_finite = max_finite;
  p.ovf_mode = sat ? 0 : (inf ? 1 : 2);
  p.identity = (m >= 23) && (e >= 8) && inf && !sat;
  p.fmask = fault > 0 ? shl_one(fault - 1) : 0u;
  return p;
}

// one element on the f32 carrier. All selects are made on bit patterns, so
// NaN payloads and the sign of zero go through untouched.
__device__ __forceinline__ float quantize_one(float x, const RowParams& p) {
  const uint32_t xb = (uint32_t)__float_as_int(x);
  const uint32_t xabs = xb & kAbsMask;

  // 1) normal range: mantissa RNE by the carrier-grid bit trick
  uint32_t yb = xb;
  if (p.knz) {
    const uint32_t lsb = (xb >> p.k) & 1u;
    yb = (xb + p.half_m1 + lsb) & p.keep;
  }

  // 2) subnormal range of the target: RNE onto the fixed-point grid.
  //    Two separate roundings (no fma); the product by ssinv is exact.
  if (p.use_sub && fabsf(x) < p.min_normal) {
    const float scaled = __fmul_rn(x, p.ssinv);
    yb = (uint32_t)__float_as_int(__fmul_rn(rintf(scaled), p.ss));
  }

  // 3) overflow of the rounded value
  if (p.ovf_gate && fabsf(__int_as_float((int)yb)) > p.max_finite) {
    const uint32_t sign = yb & 0x80000000u;
    if (p.ovf_mode == 0) {
      yb = sign | (uint32_t)__float_as_int(p.max_finite);
    } else if (p.ovf_mode == 1) {
      yb = sign | kInfBits;
    } else {
      yb = kQuietNaN;
    }
  }

  // 4) NaN / +/-inf inputs and the identity row restore x bit for bit
  if (xabs >= kInfBits || p.identity) yb = xb;

  // 5) fault channel
  return __int_as_float((int)(yb ^ p.fmask));
}

// ---------------------------------------------------------------------------
// storage types: widen in registers, narrow with RNE on the store
// ---------------------------------------------------------------------------

template <typename T> struct Storage;

template <> struct Storage<float> {
  static constexpr int kVec = 4;                 // elements per 16 bytes
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <> struct Storage<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <> struct Storage<__half> {
  static constexpr int kVec = 8;
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static void store(__half* p, float v) { *p = __float2half_rn(v); }
};

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
