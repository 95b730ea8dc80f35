// Fixed-accuracy ZFP block encode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/zfp_codec.py::zfp_encode_blocks_fa
// (_encode_fa_kernel, pallas_call at line 313): per block, a bit-twiddled
// frexp for emax (flushed to 0 below 2^-120), quantize at Q = 28 with round
// half to even, forward lift, negabinary, a plane guess
// clip(emax - floor(log2 tol) + 2, 0, 30) (the floor(log2) comes in from
// the wrapper, as on the TPU), zero planes for an all-zero block, up to six
// passes that add 2 planes wherever the L-inf error exceeds tol, and a pack
// of all 15 words.
//
// Bound on the H100: memory, for the passes real data needs.  Each block
// reads 72 bytes (16 values, tol, log2 tol) and writes 68 (15 words, emax,
// nplanes).  Per value the front end, each error check and the pack are a
// few tens of operations and shuffles; at the one or two checks a block
// needs the bytes take longer than the operations.
//
// Design (replaces one thread per block: six unconditional passes, a
// scalar 1,920-operation pack, and loads and stores that touched a sector
// per thread): four lanes per block, eight blocks per warp (zfp_lanes.cuh).
// Lane q loads row q of its block as one 16-byte read (a warp reads 512
// contiguous bytes); row and column lifts run in the lane, with one 4 x 4
// shuffle transpose between them; max |x| and the L-inf error reduce over
// the group's four lanes by two shuffles.  Early exit: a pass cannot change
// a block whose previous check found the error within tol, nor one at 30
// planes, so a block stops there; the warp stops when none of its blocks is
// live (a warp-uniform __any_sync), after at most MAX_FIX_ITERS passes.  The
// output is the six-pass kernel's bit for bit.  The error is one fused
// multiply-add, flush(deci 2^(emax - 28) - x), as XLA contracts it (the
// scaled value neither flushed nor overflowed first).  The pack: a 16 x 16
// bit-matrix transpose of the coefficients (about 70 operations a lane)
// instead of 1,920 a block; each lane then writes up to four words.  The
// ragged edge: a lane past the end encodes a zero block with tol 1 and
// stores nothing.  Callers trim words with trim_to_nplanes.
#include <cuda_runtime.h>

#include "zfp_lanes.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kBlocksPerCta = kThreads / 4;

__global__ void __launch_bounds__(kThreads)
encode_fa_kernel(const float* __restrict__ blocks, const float* __restrict__ tols,
                 const int32_t* __restrict__ log2tols, int32_t* __restrict__ payload,
                 int32_t* __restrict__ emax_out, int32_t* __restrict__ nplanes_out,
                 long long nb) {
  using namespace zfp::lanes;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (8 * (t >> 5) >= nb) return;                // the whole warp: no collective left
  const int q = threadIdx.x & 3;
  const int group = (threadIdx.x & 31) >> 2;
  const long long b = t >> 2;
  const bool valid = b < nb;

  float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (valid) {
    const float4 row = reinterpret_cast<const float4*>(blocks)[b * 4 + q];
    x[0] = row.x;
    x[1] = row.y;
    x[2] = row.z;
    x[3] = row.w;
  }
  uint32_t u_full[4];
  const int emax = encode_front(x, q, u_full);
  const float tol = valid ? __fadd_rn(tols[b], 0.0f) : 1.0f;
  const uint32_t nonzero =
      __ballot_sync(kFull, (u_full[0] | u_full[1] | u_full[2] | u_full[3]) != 0u);
  const int log2tol = valid ? log2tols[b] : 0;
  int npl = min(max(emax - log2tol + zfp::kGuardBits, 0), zfp::kTotalPlanes);
  if (((nonzero >> (4 * group)) & 0xFu) == 0u) npl = 0;        // an all-zero block

  // f1 = 2^floor(e / 2) is normal, so deci * f1 is exact; the fused
  // multiply-add rounds deci 2^e - x once and flushes only the difference
  const int e = emax - zfp::kQ;
  const float f1 = __int_as_float(((e >> 1) + 127) << 23);
  const float f2 = __int_as_float((e - (e >> 1) + 127) << 23);
  bool live = npl < zfp::kTotalPlanes;
  for (int it = 0; it < zfp::kMaxFixIters && __any_sync(kFull, live); ++it) {
    const uint32_t mask = zfp::plane_mask(npl);
    uint32_t u[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) u[r] = u_full[r] & mask;
    int32_t deci[4];
    inv_transform(u, q, deci);
    float err = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      err = zfp::max_nan(err, fabsf(__fmaf_rn(__fmul_rn(__int2float_rn(deci[c]), f1), f2,
                                              -x[c])));
    err = group_max(err);                        // every lane: a full-mask shuffle
    // a NaN error (a NaN in the block) is never > tol: the block settles
    const bool bad = live && err > tol;
    if (bad) npl = min(npl + 2, zfp::kTotalPlanes);
    live = bad && npl < zfp::kTotalPlanes;
  }

  const uint32_t mask = zfp::plane_mask(npl);
  uint32_t rows[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) rows[r] = u_full[r] & mask;
  bit_transpose16(rows, q);
  uint32_t words[4];
  int index[4];
  words_of_rows(rows, q, words, index);
  if (!valid) return;
  int32_t* p = payload + b * zfp::kMaxWords;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (index[r] >= 0) p[index[r]] = static_cast<int32_t>(words[r]);
  if (q == 3) emax_out[b] = emax;
  if (q == 2) nplanes_out[b] = npl;
}

}  // namespace

extern "C" int zfp_encode_blocks_fa_launch(const void* blocks, const void* tols,
                                           const void* log2tols, void* payload, void* emax,
                                           void* nplanes, long long nb, void* stream) {
  if (nb <= 0) return 0;
  const long long grid = (nb + kBlocksPerCta - 1) / kBlocksPerCta;
  encode_fa_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const float*>(tols),
      static_cast<const int32_t*>(log2tols), static_cast<int32_t*>(payload),
      static_cast<int32_t*>(emax), static_cast<int32_t*>(nplanes), nb);
  return static_cast<int>(cudaGetLastError());
}
