// Fixed-accuracy ZFP block decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/zfp_codec.py::zfp_decode_blocks_fa
// (_decode_fa_kernel): per block, unpack W words into 16 negabinary lanes,
// zero the planes below 30 - nplanes, map negabinary to int, inverse lift
// (columns then rows), and multiply by the exact 2^(emax - 28).
//
// Bound on the H100: memory.  The kernel reads nb * (W + 2) * 4 bytes
// (payload, emax, nplanes) and writes nb * 64 bytes, against some 250
// integer operations per block; at 3.35 TB/s the bytes dominate.
//
// Design: one thread per 4x4 block, its 16 lanes in registers; the ragged
// edge is masked (no padding copy as the TPU's 256-row tiles needed).
// Not yet done: 16 threads per block with __shfl_sync lifts, the payload[idx]
// gather fused into the kernel, and coalesced 16-byte stores.
#include <cuda_runtime.h>

#include "zfp_common.cuh"

namespace {

__global__ void decode_fa_kernel(const int32_t* __restrict__ payload,
                                 const int32_t* __restrict__ emax,
                                 const int32_t* __restrict__ nplanes,
                                 float* __restrict__ out, long long nb, int num_words) {
  long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint32_t u[16];
  zfp::unpack_words(payload + b * num_words, num_words, u);
  const uint32_t mask = zfp::plane_mask(nplanes[b]);
#pragma unroll
  for (int l = 0; l < 16; ++l) u[l] &= mask;
  float v[16];
  zfp::decode_block(u, emax[b], v);
  float* o = out + b * 16;
#pragma unroll
  for (int l = 0; l < 16; ++l) o[l] = v[l];
}

}  // namespace

extern "C" int zfp_decode_blocks_fa_launch(const void* payload, const void* emax,
                                           const void* nplanes, void* out, long long nb,
                                           int num_words, void* stream) {
  if (nb <= 0) return 0;
  const int threads = 256;
  const long long grid = (nb + threads - 1) / threads;
  decode_fa_kernel<<<static_cast<unsigned int>(grid), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(payload), static_cast<const int32_t*>(emax),
      static_cast<const int32_t*>(nplanes), static_cast<float*>(out), nb, num_words);
  return static_cast<int>(cudaGetLastError());
}
