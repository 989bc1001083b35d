// Device code of the dynamic (e, m) round-to-nearest-even quantizer, shared
// by every kernel of the port that rounds a value onto a runtime format row:
//
//   kernels/quantize_em/csrc/quantize_em.cu      (the standalone quantizers)
//   kernels/flash_attention/csrc/flash_attention.cu  (fused epilogue)
//   kernels/rwkv6/csrc/wkv6.cu                   (fused epilogue on y)
//
// Because the fused epilogues call the same derive_row / quantize_one as
// quantize_em_dynamic, "kernel with a row" is bit for bit "kernel without a
// row, then quantize_em_dynamic on the stored tensor" by construction, not
// by keeping two copies in step.
//
// Bit-exactness needs every file that includes this header to be built
// WITHOUT --use_fast_math and with -ftz=false -prec-div=true -fmad=false:
// denormals must not flush on the subnormal branch, rintf is ties-to-even,
// the reciprocal of a power of two is exact, and no multiply-add may be
// contracted. (A kernel that wants an fma elsewhere writes __fmaf_rn.)
//
// The build key of every library hashes this file (kernels/_build.py), so an
// edit here rebuilds all of them.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace repro_q {

constexpr uint32_t kQuietNaN = 0x7FC00000u;   // the positive quiet NaN
constexpr uint32_t kInfBits = 0x7F800000u;
constexpr uint32_t kAbsMask = 0x7FFFFFFFu;

// ---------------------------------------------------------------------------
// rounding constants: one struct serves every kernel
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
// dynamic_row_params of kernels/quantize_em/ref.py operation for operation
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
  __device__ static float narrow(float v) { return v; }
};

template <> struct Storage<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // the value a store followed by a load gives back
  __device__ static float narrow(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <> struct Storage<__half> {
  static constexpr int kVec = 8;
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static void store(__half* p, float v) { *p = __float2half_rn(v); }
  __device__ static float narrow(float v) {
    return __half2float(__float2half_rn(v));
  }
};

// The fused epilogue of a kernel that stores ``v`` into storage type T:
// narrow to T (the value the unfused kernel would store), then, when a row
// is wired in (``fused``), widen, round onto the row's format, XOR the fault
// bit and narrow again -- exactly quantize_em_dynamic on the stored tensor.
template <typename T>
__device__ __forceinline__ void store_epilogue(T* dst, float v, bool fused,
                                               const RowParams& p) {
  if (fused) v = quantize_one(Storage<T>::narrow(v), p);
  Storage<T>::store(dst, v);
}

}  // namespace repro_q
