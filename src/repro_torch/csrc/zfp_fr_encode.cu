// Fixed-rate ZFP block encode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/zfp_codec.py::zfp_encode_blocks
// (_encode_kernel, pallas_call at line 346): per block, a bit-twiddled frexp
// for emax (flushed to 0 below 2^-120), quantize at Q = 28 with round half
// to even, forward lift, negabinary, keep the top bits_per_value planes
// (u & 0xFFFFFFFF << (30 - bits), a shift of at most 29) and pack
// W = (bits + 1) / 2 words.
//
// Bound on the H100: memory at every rate.  Each block reads 64 bytes and
// writes 4W + 4 (W words and emax), against 128 W + 293 operations (the
// front end of the fixed-accuracy encode, the truncation and the W-word
// pack), well under the card's operations-per-byte balance.
//
// Design: the front end is the fixed-accuracy encode's (zfp_common.cuh
// encode_front: flush on load, exponent-field powers of two, NaN-propagating
// maxima, saturating __float2int_rn, uint32 adds and shifts); no error
// check, so no floor(log2 tol) enters.  One thread per 4x4 block, the
// ragged edge masked, output (nb, W), never the full 15 words.  Not yet
// done: spreading a block over 16 threads.
#include <cuda_runtime.h>

#include "zfp_common.cuh"

namespace {

__global__ void encode_fr_kernel(const float* __restrict__ blocks,
                                 int32_t* __restrict__ payload, int32_t* __restrict__ emax_out,
                                 long long nb, int bits) {
  long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  float x[16];
  uint32_t u[16];
  const int emax = zfp::encode_front(blocks + b * 16, x, u);
  const uint32_t mask = zfp::plane_mask(bits);
#pragma unroll
  for (int l = 0; l < 16; ++l) u[l] &= mask;
  const int num_words = (bits + 1) / 2;
  zfp::pack_words(u, num_words, payload + b * num_words);
  emax_out[b] = emax;
}

}  // namespace

extern "C" int zfp_encode_blocks_launch(const void* blocks, void* payload, void* emax,
                                        long long nb, int bits, void* stream) {
  if (nb <= 0) return 0;
  const int threads = 256;
  const long long grid = (nb + threads - 1) / threads;
  encode_fr_kernel<<<static_cast<unsigned int>(grid), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<int32_t*>(payload),
      static_cast<int32_t*>(emax), nb, bits);
  return static_cast<int>(cudaGetLastError());
}
