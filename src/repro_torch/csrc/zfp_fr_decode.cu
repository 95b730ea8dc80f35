// Fixed-rate ZFP block decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/zfp_codec.py::zfp_decode_blocks
// (_decode_kernel, pallas_call at line 127): per block, unpack W words into
// 16 negabinary lanes (plane 29 - 2k in bits 0-15 of word k, plane 28 - 2k
// in bits 16-31), map negabinary to int, inverse lift (columns then rows)
// and multiply by the exact 2^(emax - 28).  No plane mask: planes beyond
// the W stored words are simply absent, and at odd bits_per_value the low
// half of the last word is zero by construction.
//
// Bound on the H100: memory.  The kernel reads nb * (4W + 4) bytes (payload
// and emax) and writes nb * 64 bytes, against 128 W + 208 integer and float
// operations per block; at 3.35 TB/s the bytes dominate.
//
// Design: the fixed-accuracy decode without its mask, on the same helpers
// (zfp_common.cuh): one thread per 4x4 block, its 16 lanes in registers,
// the ragged edge masked.  Not yet done: 16 threads per block with
// __shfl_sync lifts and coalesced 16-byte stores.
#include <cuda_runtime.h>

#include "zfp_common.cuh"

namespace {

__global__ void decode_fr_kernel(const int32_t* __restrict__ payload,
                                 const int32_t* __restrict__ emax,
                                 float* __restrict__ out, long long nb, int num_words) {
  long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint32_t u[16];
  zfp::unpack_words(payload + b * num_words, num_words, u);
  float v[16];
  zfp::decode_block(u, emax[b], v);
  float* o = out + b * 16;
#pragma unroll
  for (int l = 0; l < 16; ++l) o[l] = v[l];
}

}  // namespace

extern "C" int zfp_decode_blocks_launch(const void* payload, const void* emax, void* out,
                                        long long nb, int num_words, void* stream) {
  if (nb <= 0) return 0;
  const int threads = 256;
  const long long grid = (nb + threads - 1) / threads;
  decode_fr_kernel<<<static_cast<unsigned int>(grid), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(payload), static_cast<const int32_t*>(emax),
      static_cast<float*>(out), nb, num_words);
  return static_cast<int>(cudaGetLastError());
}
