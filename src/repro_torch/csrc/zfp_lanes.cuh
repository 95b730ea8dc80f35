// Lane-parallel device code of the redesigned ZFP kernels (both decodes and
// the fixed-accuracy encode): four lanes per 4x4 block, eight blocks per
// warp.
//
// Layouts.  In the row layout lane q of a block's group of four holds row q
// of the block (values 4q .. 4q + 3, one 16-byte access); in the column
// layout it holds column q (values q, q + 4, q + 8, q + 12).  A 4-point
// lift of a row or a column runs in the lane on the shared lifts of
// zfp_common.cuh, so the arithmetic is the per-thread kernels' and the
// results are bit-identical; transpose4 moves between the two layouts with
// four shuffles.  The forward transform is rows then columns (it ends in
// the column layout), the inverse columns then rows (it ends in the row
// layout, where the values were loaded).
//
// Bit planes.  Word k of the payload holds plane 29 - 2k of the 16 values
// in bits 0-15 and plane 28 - 2k in bits 16-31.  Packing is a 16 x 16
// bit-matrix transpose of the 16 coefficients, run on both 16-bit halves at
// once: afterwards row j holds plane j in bits 0-15 and plane 16 + j in bits
// 16-31.  Its four stages swap bit blocks between rows 8, 4, 2 and 1 apart;
// in the column layout the first two pair registers of one lane, the last
// two pair lanes (one shuffle each).  The transpose is its own inverse, so
// unpacking builds the transposed rows from the words and runs it again.
//
// Every lane of the warp must reach every shuffle and ballot (full mask), so
// a lane whose block lies past the end computes on a dummy block and skips
// its stores; a warp whose blocks all lie past the end returns whole.
#pragma once

#include "zfp_common.cuh"

namespace zfp {
namespace lanes {

constexpr unsigned kFull = 0xFFFFFFFFu;

// 4 x 4 transpose across a group's four lanes: lane q holds row q
// (v[c] = A[q][c]) before and column q (v[r] = A[r][q]) after, or the
// reverse.  Off-diagonal 2 x 2 blocks swap between lanes q and q ^ 2, then
// off-diagonal entries of each 2 x 2 block between lanes q and q ^ 1.
__device__ __forceinline__ void transpose4(int32_t v[4], int q) {
  const bool lo2 = (q & 2) == 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int32_t recv = __shfl_xor_sync(kFull, lo2 ? v[e + 2] : v[e], 2);
    if (lo2) v[e + 2] = recv; else v[e] = recv;
  }
  const bool lo1 = (q & 1) == 0;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int32_t recv = __shfl_xor_sync(kFull, lo1 ? v[e + 1] : v[e], 1);
    if (lo1) v[e + 1] = recv; else v[e] = recv;
  }
}

// max over a group's four lanes (a max is exact in any order; NaN wins)
__device__ __forceinline__ float group_max(float v) {
  v = max_nan(v, __shfl_xor_sync(kFull, v, 1));
  return max_nan(v, __shfl_xor_sync(kFull, v, 2));
}

// one stage of the bit transpose on rows a (row i) and b (row i + s) of one
// lane: bits s..2s-1 of each 2s-bit block of a trade places with bits
// 0..s-1 of b, in both halves (m selects the low s bits of each block)
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b, int s, uint32_t m) {
  const uint32_t t = ((a >> s) ^ b) & m;
  b ^= t;
  a ^= t << s;
}

// the same stage between this lane's row and the partner lane's (q ^ s);
// lower: this lane holds the row of the pair with the smaller index
__device__ __forceinline__ uint32_t swap_bits_across(uint32_t mine, int s, uint32_t m,
                                                     bool lower) {
  const uint32_t other = __shfl_xor_sync(kFull, mine, s);
  const uint32_t t = lower ? (((mine >> s) ^ other) & m) : (((other >> s) ^ mine) & m);
  return lower ? (mine ^ (t << s)) : (mine ^ t);
}

// 16 x 16 bit transpose of the block's rows (both halves at once) held in
// the column layout: u[r] is row 4r + q
__device__ __forceinline__ void bit_transpose16(uint32_t u[4], int q) {
  swap_bits(u[0], u[2], 8, 0x00FF00FFu);
  swap_bits(u[1], u[3], 8, 0x00FF00FFu);
  swap_bits(u[0], u[1], 4, 0x0F0F0F0Fu);
  swap_bits(u[2], u[3], 4, 0x0F0F0F0Fu);
#pragma unroll
  for (int r = 0; r < 4; ++r) u[r] = swap_bits_across(u[r], 2, 0x33333333u, (q & 2) == 0);
#pragma unroll
  for (int r = 0; r < 4; ++r) u[r] = swap_bits_across(u[r], 1, 0x55555555u, (q & 1) == 0);
}

// the encoders' front end for one lane: flush on load, emax from the
// block's max |x| (0 below 2^-120 and for NaN, 129 for inf), quantize at
// Q = 28 with round half to even, saturating, forward lift (rows, then
// columns), negabinary.  x holds row q on
// entry and its flushed values on return; u receives column q's
// negabinary coefficients (rows 4r + q of the bit matrix).  Returns emax.
__device__ __forceinline__ int encode_front(float x[4], int q, uint32_t u[4]) {
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = __fadd_rn(x[c], 0.0f);
    m = max_nan(m, fabsf(x[c]));
  }
  const float maxabs = group_max(m);
  const int e = ((__float_as_int(maxabs) >> 23) & 0xFF) - 126;
  const int emax = (maxabs >= 0x1p-120f) ? e : 0;
  int32_t v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = __float2int_rn(scale_by_pow2(x[c], kQ - emax));
  fwd_lift4(v[0], v[1], v[2], v[3]);
  transpose4(v, q);
  fwd_lift4(v[0], v[1], v[2], v[3]);
#pragma unroll
  for (int r = 0; r < 4; ++r) u[r] = int2nb(v[r]);
  return emax;
}

// negabinary coefficients in the column layout -> this lane's row of
// integers (inverse lift: columns in the lane, transpose, rows in the lane)
__device__ __forceinline__ void inv_transform(const uint32_t u[4], int q, int32_t v[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = nb2int(u[r]);
  inv_lift4(v[0], v[1], v[2], v[3]);
  transpose4(v, q);
  inv_lift4(v[0], v[1], v[2], v[3]);
}

// Words of the payload from the transposed rows (column layout: t[r] is row
// 4r + q).  Lanes q and q ^ 1 hold rows 2i and 2i + 1; the even lane writes
// word 6 - 2r - q/2 (planes 29 - 2k and 28 - 2k >= 16: the rows' high
// halves) and the odd lane word 14 - 2r - q/2 (planes below 16: the low
// halves).  word_index receives -1 where no word is due.
__device__ __forceinline__ void words_of_rows(const uint32_t t[4], int q, uint32_t w[4],
                                              int word_index[4]) {
  const bool even = (q & 1) == 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t other = __shfl_xor_sync(kFull, t[r], 1);
    const uint32_t r0 = even ? t[r] : other;     // row 4r + (q & 2)
    const uint32_t r1 = even ? other : t[r];     // the row after it
    w[r] = even ? ((r1 >> 16) | (r0 & 0xFFFF0000u)) : ((r1 & 0xFFFFu) | (r0 << 16));
    word_index[r] = (even ? 6 : 14) - 2 * r - (q >> 1);
  }
}

// the transposed row 4r + q of a block from its W words (absent words are
// zero): the inverse of words_of_rows
__device__ __forceinline__ uint32_t row_of_words(const int32_t* __restrict__ p, int num_words,
                                                 int r, int q) {
  const int j = 4 * r + q;
  const int k_hi = (13 - j) >> 1;            // the word holding plane 16 + j
  const int k_lo = k_hi + 8;                 // the word holding plane j
  uint32_t hi = 0u, lo = 0u;
  if (j <= 13 && k_hi < num_words) hi = static_cast<uint32_t>(p[k_hi]);
  if (k_lo < num_words) lo = static_cast<uint32_t>(p[k_lo]);
  return (j & 1) ? ((hi << 16) | (lo & 0xFFFFu)) : ((hi & 0xFFFF0000u) | (lo >> 16));
}

}  // namespace lanes
}  // namespace zfp

// return CALL(W) for the payload width num_words, a template parameter
// 1..15 of the lane kernels; cudaErrorInvalidValue for any other width
#define ZFP_DISPATCH_WORDS(num_words, CALL)                  \
  switch (num_words) {                                       \
    case 1: return CALL(1);                                  \
    case 2: return CALL(2);                                  \
    case 3: return CALL(3);                                  \
    case 4: return CALL(4);                                  \
    case 5: return CALL(5);                                  \
    case 6: return CALL(6);                                  \
    case 7: return CALL(7);                                  \
    case 8: return CALL(8);                                  \
    case 9: return CALL(9);                                  \
    case 10: return CALL(10);                                \
    case 11: return CALL(11);                                \
    case 12: return CALL(12);                                \
    case 13: return CALL(13);                                \
    case 14: return CALL(14);                                \
    case 15: return CALL(15);                                \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
