// Fixed-accuracy ZFP block encode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/zfp_codec.py::zfp_encode_blocks_fa
// (_encode_fa_kernel): per block, a bit-twiddled frexp for emax (flushed to
// 0 below 2^-120), quantize at Q = 28 with round half to even, forward lift,
// negabinary, a plane guess clip(emax - floor(log2 tol) + 2, 0, 30) (the
// floor(log2) comes in from the wrapper, as on the TPU), zero planes for an
// all-zero block, six passes that add 2 planes wherever the L-inf error
// exceeds tol, and a pack of all 15 words.
//
// Bound on the H100: integer and float work.  Each block reads 72 bytes
// (16 values, tol, log2 tol) and writes 68 (15 words, emax, nplanes), but
// runs about 3,000 operations: one forward and six inverse lifts, six
// dequantize-and-compare passes, and the 30-plane pack.
//
// Design: one thread per 4x4 block, values and coefficients in registers;
// the six correction passes are unrolled as in the Pallas body; the ragged
// edge is masked (no padding copy).  Callers trim words with
// trim_to_nplanes.  Not yet done: spreading a block over 16 threads.
#include <cuda_runtime.h>

#include "zfp_common.cuh"

namespace {

__global__ void encode_fa_kernel(const float* __restrict__ blocks,
                                 const float* __restrict__ tols,
                                 const int32_t* __restrict__ log2tols,
                                 int32_t* __restrict__ payload, int32_t* __restrict__ emax_out,
                                 int32_t* __restrict__ nplanes_out, long long nb) {
  long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  float x[16];
  uint32_t u_full[16];
  const int emax = zfp::encode_front(blocks + b * 16, x, u_full);
  const float tol = __fadd_rn(tols[b], 0.0f);
  bool all_zero = true;
#pragma unroll
  for (int l = 0; l < 16; ++l) all_zero = all_zero && (u_full[l] == 0u);
  int npl = min(max(emax - log2tols[b] + zfp::kGuardBits, 0), zfp::kTotalPlanes);
  if (all_zero) npl = 0;
#pragma unroll
  for (int it = 0; it < zfp::kMaxFixIters; ++it) {
    const uint32_t mask = zfp::plane_mask(npl);
    uint32_t u[16];
#pragma unroll
    for (int l = 0; l < 16; ++l) u[l] = u_full[l] & mask;
    float dec[16];
    zfp::decode_block(u, emax, dec);
    float err = 0.0f;
#pragma unroll
    for (int l = 0; l < 16; ++l) err = fmaxf(err, fabsf(__fsub_rn(dec[l], x[l])));
    if (err > tol) npl = min(npl + 2, zfp::kTotalPlanes);
  }

  const uint32_t mask = zfp::plane_mask(npl);
  uint32_t u[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) u[l] = u_full[l] & mask;
  zfp::pack_words(u, zfp::kMaxWords, payload + b * zfp::kMaxWords);
  emax_out[b] = emax;
  nplanes_out[b] = npl;
}

}  // namespace

extern "C" int zfp_encode_blocks_fa_launch(const void* blocks, const void* tols,
                                           const void* log2tols, void* payload, void* emax,
                                           void* nplanes, long long nb, void* stream) {
  if (nb <= 0) return 0;
  const int threads = 256;
  const long long grid = (nb + threads - 1) / threads;
  encode_fa_kernel<<<static_cast<unsigned int>(grid), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const float*>(tols),
      static_cast<const int32_t*>(log2tols), static_cast<int32_t*>(payload),
      static_cast<int32_t*>(emax), static_cast<int32_t*>(nplanes), nb);
  return static_cast<int>(cudaGetLastError());
}
