// Fixed-rate ZFP block decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/zfp_codec.py::zfp_decode_blocks
// (_decode_kernel, pallas_call at line 127): per block, unpack W words into
// 16 negabinary lanes (plane 29 - 2k in bits 0-15 of word k, plane 28 - 2k
// in bits 16-31), map negabinary to int, inverse lift (columns then rows)
// and multiply by the exact 2^(emax - 28).  No plane mask: planes beyond
// the W stored words are simply absent, and at odd bits_per_value the low
// half of the last word is zero by construction.  The FA streams of the
// host-streaming stores, padded to the batch's widest sample, decode here
// at 2 * wmax planes as any stream of that width.
//
// Bound on the H100: memory.  The kernel reads nb * (4W + 4) bytes (payload
// and emax) and writes nb * 64 bytes; per block the function's work is
// some 100 W + 200 integer and float operations (unpack, negabinary, eight
// 4-point lifts, dequantize), under the card's operations-per-byte balance.
//
// Design (replaces one thread per block, whose scalar unpack cost 128
// operations per word and whose loads and stores touched a sector per
// thread): four lanes per block, eight blocks per warp (zfp_lanes.cuh).
// Lane q builds the transposed bit rows 4r + q from the words (two loads
// each, absent words zero), one 16 x 16 bit-matrix transpose (two stages in
// the lane, two by shuffles) gives column q's coefficients, the column
// lifts run in the lane, one 4 x 4 shuffle transpose turns the block to
// rows, the row lifts run in the lane, and lane q stores row q as one
// 16-byte write (a warp writes 512 contiguous bytes).  W is a template
// parameter (1..15).  The ragged edge: a lane whose block is past the end
// decodes zeros and stores nothing.
#include <cuda_runtime.h>

#include "zfp_lanes.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kBlocksPerCta = kThreads / 4;

template <int W>
__global__ void __launch_bounds__(kThreads)
decode_fr_kernel(const int32_t* __restrict__ payload, const int32_t* __restrict__ emax,
                 float* __restrict__ out, long long nb) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (8 * (t >> 5) >= nb) return;                // the whole warp: no collective left
  const int q = threadIdx.x & 3;
  const long long b = t >> 2;
  const bool valid = b < nb;
  uint32_t u[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    u[r] = valid ? zfp::lanes::row_of_words(payload + b * W, W, r, q) : 0u;
  zfp::lanes::bit_transpose16(u, q);
  int32_t v[4];
  zfp::lanes::inv_transform(u, q, v);
  const int e = (valid ? emax[b] : 0) - zfp::kQ;
  float4 f;
  f.x = zfp::scale_by_pow2(__int2float_rn(v[0]), e);
  f.y = zfp::scale_by_pow2(__int2float_rn(v[1]), e);
  f.z = zfp::scale_by_pow2(__int2float_rn(v[2]), e);
  f.w = zfp::scale_by_pow2(__int2float_rn(v[3]), e);
  if (valid) reinterpret_cast<float4*>(out)[b * 4 + q] = f;
}

template <int W>
int launch(const void* payload, const void* emax, void* out, long long nb,
           cudaStream_t stream) {
  const long long grid = (nb + kBlocksPerCta - 1) / kBlocksPerCta;
  decode_fr_kernel<W><<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(payload), static_cast<const int32_t*>(emax),
      static_cast<float*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zfp_decode_blocks_launch(const void* payload, const void* emax, void* out,
                                        long long nb, int num_words, void* stream) {
  if (nb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZFP_FR(W) launch<W>(payload, emax, out, nb, s)
  ZFP_DISPATCH_WORDS(num_words, ZFP_FR)
#undef ZFP_FR
}
