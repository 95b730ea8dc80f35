// Shared device arithmetic of the ZFP kernels (fixed-accuracy and fixed-rate).
//
// Same constants and block layout as repro/compression/transform.py: a 4x4
// block is 16 lanes in row-major order; the payload holds two 16-lane bit
// planes per int32 word, MSB plane first.
//
// Integer rules.  Every add, subtract and left shift runs on uint32_t, where
// wraparound is defined (signed overflow is undefined behaviour in C++, and
// the reference relies on int32 wraparound in the negabinary map).  The
// lifts' right shifts are arithmetic shifts on int32_t, which nvcc emits for
// signed operands (shr.s32).
//
// Float rules.  Built with --ftz=true so subnormal inputs and results flush
// to sign-preserving zero exactly as XLA does, and with --fmad=false so
// (x * f1) * f2 - y never contracts into an FMA.  Powers of two come from
// the exponent field, never from exp2f/ldexpf.
//
// Non-finite values.  Every maximum propagates NaN (max_nan), as jnp.max
// does; fmaxf would drop it.  Float-to-int conversions use
// __float2int_rn (cvt.rni.s32.f32: round half to even, saturating, NaN to
// 0), as XLA's convert saturates; a static_cast is undefined there.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace zfp {

constexpr int kQ = 28;             // Q_FIXED_POINT
constexpr int kTotalPlanes = 30;   // TOTAL_PLANES
constexpr int kMaxWords = 15;      // MAX_WORDS
constexpr int kGuardBits = 2;      // GUARD_BITS
constexpr int kMaxFixIters = 6;    // MAX_FIX_ITERS
constexpr uint32_t kNeg = 0xAAAAAAAAu;

// max(a, b) that returns NaN when either is NaN (PTX max.NaN, sm_80+)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t shl1(int32_t a) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << 1);
}

// inverse lift of one 4-vector (transform.py _inv_lift4)
__device__ __forceinline__ void inv_lift4(int32_t& x, int32_t& y, int32_t& z, int32_t& w) {
  y = add(y, w >> 1);
  w = sub(w, y >> 1);
  y = add(y, w);
  w = sub(shl1(w), y);
  z = add(z, x);
  x = sub(shl1(x), z);
  y = add(y, z);
  z = sub(shl1(z), y);
  w = add(w, x);
  x = sub(shl1(x), w);
}

// forward lift of one 4-vector (transform.py _fwd_lift4)
__device__ __forceinline__ void fwd_lift4(int32_t& x, int32_t& y, int32_t& z, int32_t& w) {
  x = add(x, w);
  x = x >> 1;
  w = sub(w, x);
  z = add(z, y);
  z = z >> 1;
  y = sub(y, z);
  x = add(x, z);
  x = x >> 1;
  z = sub(z, x);
  w = add(w, y);
  w = w >> 1;
  y = sub(y, w);
  w = add(w, y >> 1);
  y = sub(y, w >> 1);
}

// forward 2D lift in place: rows, then columns
__device__ __forceinline__ void fwd_transform(int32_t v[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) fwd_lift4(v[4 * r], v[4 * r + 1], v[4 * r + 2], v[4 * r + 3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) fwd_lift4(v[c], v[c + 4], v[c + 8], v[c + 12]);
}

__device__ __forceinline__ int32_t nb2int(uint32_t u) {
  return static_cast<int32_t>((u ^ kNeg) - kNeg);
}
__device__ __forceinline__ uint32_t int2nb(int32_t i) {
  return (static_cast<uint32_t>(i) + kNeg) ^ kNeg;
}

// keep the top npl planes: 0xFFFFFFFF << clip(30 - npl, 0, 31)
__device__ __forceinline__ uint32_t plane_mask(int npl) {
  int shift = min(max(kTotalPlanes - npl, 0), 31);
  return 0xFFFFFFFFu << shift;
}

// x * 2^e as two exact multiplies by exponent-field powers of two
// (transform.py pow2_factors / scale_by_pow2); e1 = floor(e / 2)
__device__ __forceinline__ float scale_by_pow2(float x, int e) {
  int e1 = e >> 1;
  float f1 = __int_as_float((e1 + 127) << 23);
  float f2 = __int_as_float((e - e1 + 127) << 23);
  return __fmul_rn(__fmul_rn(x, f1), f2);
}

// pack the top 2 * num_words planes of 16 negabinary lanes into num_words
// words (transform.py pack_planes; word k holds plane 29 - 2k in bits
// 0-15 and plane 28 - 2k in bits 16-31)
__device__ __forceinline__ void pack_words(const uint32_t u[16], int num_words, int32_t* out) {
  for (int k = 0; k < num_words; ++k) {
    const int p_hi = kTotalPlanes - 1 - 2 * k;
    const int p_lo = kTotalPlanes - 2 - 2 * k;
    uint32_t plane_hi = 0u, plane_lo = 0u;
#pragma unroll
    for (int l = 0; l < 16; ++l) {
      plane_hi |= ((u[l] >> p_hi) & 1u) << l;
      plane_lo |= ((u[l] >> p_lo) & 1u) << l;
    }
    out[k] = static_cast<int32_t>(plane_hi | (plane_lo << 16));
  }
}

// Encode front end shared by both encoders: load the block with the flush
// on load (adding 0.0f is an f32 op, so --ftz flushes subnormal inputs),
// a bit-twiddled frexp for emax (flushed to 0 below 2^-120 and for a NaN
// block; 129 for an inf block), quantize at Q = 28 with round half to
// even, saturating, forward lift, negabinary.  Returns emax; x receives the
// flushed values, u the negabinary coefficients.
__device__ __forceinline__ int encode_front(const float* xb, float x[16], uint32_t u[16]) {
  float maxabs = 0.0f;
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    x[l] = __fadd_rn(xb[l], 0.0f);
    maxabs = max_nan(maxabs, fabsf(x[l]));
  }
  // frexp exponent via the exponent field: maxabs = m 2^e, m in [0.5, 1)
  const int e = ((__float_as_int(maxabs) >> 23) & 0xFF) - 126;
  const int emax = (maxabs >= 0x1p-120f) ? e : 0;
  int32_t v[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) v[l] = __float2int_rn(scale_by_pow2(x[l], kQ - emax));
  fwd_transform(v);
#pragma unroll
  for (int l = 0; l < 16; ++l) u[l] = int2nb(v[l]);
  return emax;
}

}  // namespace zfp
