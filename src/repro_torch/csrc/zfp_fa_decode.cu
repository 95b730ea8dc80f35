// Fixed-accuracy ZFP block decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/zfp_codec.py::zfp_decode_blocks_fa
// (_decode_fa_kernel, pallas_call at line 190): per block, unpack W words
// into 16 negabinary lanes, zero the planes below 30 - nplanes, map
// negabinary to int, inverse lift (columns then rows), and multiply by the
// exact 2^(emax - 28).
//
// Two entry points:
// * flat: (nb, W) payload, (nb,) emax and nplanes -> (nb, 16) blocks;
// * gathered: the device-resident store's (N, nb, W) payload and (N, nb)
//   emax and nplanes, a device (B,) int64 idx and the field's padded and
//   cropped shapes -> the (B, *shape) batch.  Block g of the batch reads row
//   idx[g / nb] * nb + g % nb of the store and writes its four rows at
//   their place in the field (blockify's order: lead, block row, block
//   column), cropped.  This fuses what was three torch gathers, the flat
//   decode and the deblockify copy (five launches) into one, as XLA fuses
//   the JAX package's gather and decode into its jitted step.  An index
//   outside [0, N) is a device-side fault (__trap), as PyTorch's indexing
//   asserts; it is never clamped.
//
// Bound on the H100: memory.  Both entries read nb * (4W + 8) bytes
// (payload, emax, nplanes; the B indices are negligible) and write
// nb * 64, against some 100 W + 200 integer and float operations per block,
// under the card's operations-per-byte balance.  The gather moves no extra
// bytes.
//
// Design (replaces one thread per block, whose scalar unpack cost 128
// operations per word and whose loads and stores touched a sector per
// thread): the fixed-rate decode's four lanes per block, eight blocks per
// warp (zfp_lanes.cuh).  Lane q builds the transposed bit rows 4r + q from
// the words (absent words zero), one 16 x 16 bit-matrix transpose gives
// column q's coefficients, each is masked to the block's nplanes (the only
// difference from the fixed-rate decode), the column lifts run in the lane,
// one 4 x 4 shuffle transpose turns the block to rows, the row lifts run in
// the lane, and lane q writes row q: one 16-byte store where the row lies
// whole inside the field and aligned, element stores at the crop.  W is a
// template parameter (1..15).  The gathered entry's divisions by nb and the
// block grid run as multiply-high by host-computed magic numbers.  Every
// shuffle runs on every lane: a lane whose block is past the end decodes a
// zero dummy block and stores nothing; a warp with no block returns whole.
#include <cuda_runtime.h>

#include "zfp_lanes.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kBlocksPerCta = kThreads / 4;

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 as __umulhi(n, m) >> s, with
// m = ceil(2^(31 + l) / d) and s = l - 1, l = ceil(log2 d) (Granlund and
// Montgomery's round-up method at 31-bit precision); d = 1 is n itself.
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv make_fastdiv(uint32_t d) {
  FastDiv f{d, 0u, 0u};
  if (d == 1) return f;
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  f.m = static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d);
  f.s = l - 1;
  return f;
}

__device__ __forceinline__ uint32_t divide(uint32_t n, const FastDiv& f) {
  return f.d == 1 ? n : (__umulhi(n, f.m) >> f.s);
}

struct Field {
  long long n_samples;    // N, rows of the resident store
  long long total;        // B * nb blocks of the batch
  FastDiv nb;             // blocks per sample
  FastDiv plane;          // blocks per lead index: (Hp / 4) * (Wp / 4)
  FastDiv row;            // blocks per block row: Wp / 4
  int lead, height, width;    // the cropped sample: prod(shape[:-2]), H, W
};

// lane q's row of the block whose W words start at p, decoded at npl
// planes and scaled by 2^(emax - 28); a lane with !valid reads nothing and
// decodes a zero block (its group's shuffles still run)
template <int W>
__device__ __forceinline__ float4 decode_row(const int32_t* __restrict__ p, int emax, int npl,
                                             int q, bool valid) {
  uint32_t u[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) u[r] = valid ? zfp::lanes::row_of_words(p, W, r, q) : 0u;
  zfp::lanes::bit_transpose16(u, q);
  const uint32_t mask = zfp::plane_mask(npl);
#pragma unroll
  for (int r = 0; r < 4; ++r) u[r] &= mask;
  int32_t v[4];
  zfp::lanes::inv_transform(u, q, v);
  const int e = emax - zfp::kQ;
  float4 f;
  f.x = zfp::scale_by_pow2(__int2float_rn(v[0]), e);
  f.y = zfp::scale_by_pow2(__int2float_rn(v[1]), e);
  f.z = zfp::scale_by_pow2(__int2float_rn(v[2]), e);
  f.w = zfp::scale_by_pow2(__int2float_rn(v[3]), e);
  return f;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
decode_fa_kernel(const int32_t* __restrict__ payload, const int32_t* __restrict__ emax,
                 const int32_t* __restrict__ nplanes, float* __restrict__ out, long long nb) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (8 * (t >> 5) >= nb) return;                // the whole warp: no collective left
  const int q = threadIdx.x & 3;
  const long long b = t >> 2;
  const bool valid = b < nb;
  const float4 f = decode_row<W>(payload + (valid ? b : 0) * W, valid ? emax[b] : 0,
                                 valid ? nplanes[b] : 0, q, valid);
  if (valid) reinterpret_cast<float4*>(out)[b * 4 + q] = f;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
decode_fa_gather_kernel(const int32_t* __restrict__ payload, const int32_t* __restrict__ emax,
                        const int32_t* __restrict__ nplanes,
                        const long long* __restrict__ idx, float* __restrict__ out,
                        const Field fd) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (8 * (t >> 5) >= fd.total) return;          // the whole warp: no collective left
  const int q = threadIdx.x & 3;
  const long long g = t >> 2;
  const bool valid = g < fd.total;
  const uint32_t gi = valid ? static_cast<uint32_t>(g) : 0u;
  const uint32_t s = divide(gi, fd.nb);          // the batch's sample
  const uint32_t j = gi - s * fd.nb.d;           // the block within it
  long long src = 0;
  if (valid) {
    const long long i = idx[s];
    if (i < 0 || i >= fd.n_samples) __trap();    // as PyTorch's index assert
    src = i * fd.nb.d + j;
  }
  const float4 f = decode_row<W>(payload + src * W, valid ? emax[src] : 0,
                                 valid ? nplanes[src] : 0, q, valid);
  if (!valid) return;
  const uint32_t c = divide(j, fd.plane);
  const uint32_t rem = j - c * fd.plane.d;
  const uint32_t by = divide(rem, fd.row);
  const int x0 = 4 * static_cast<int>(rem - by * fd.row.d);
  const int y = 4 * static_cast<int>(by) + q;
  if (y >= fd.height) return;                    // a padded row
  const long long o =
      ((static_cast<long long>(s) * fd.lead + c) * fd.height + y) * fd.width + x0;
  float* dst = out + o;
  if (x0 + 4 <= fd.width && (o & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = f;
  } else {                                       // at the crop, or unaligned
    if (x0 < fd.width) dst[0] = f.x;
    if (x0 + 1 < fd.width) dst[1] = f.y;
    if (x0 + 2 < fd.width) dst[2] = f.z;
    if (x0 + 3 < fd.width) dst[3] = f.w;
  }
}

template <int W>
int launch_flat(const void* payload, const void* emax, const void* nplanes, void* out,
                long long nb, cudaStream_t stream) {
  const long long grid = (nb + kBlocksPerCta - 1) / kBlocksPerCta;
  decode_fa_kernel<W><<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(payload), static_cast<const int32_t*>(emax),
      static_cast<const int32_t*>(nplanes), static_cast<float*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_gather(const void* payload, const void* emax, const void* nplanes, const void* idx,
                  void* out, const Field& fd, cudaStream_t stream) {
  const long long grid = (fd.total + kBlocksPerCta - 1) / kBlocksPerCta;
  decode_fa_gather_kernel<W><<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(payload), static_cast<const int32_t*>(emax),
      static_cast<const int32_t*>(nplanes), static_cast<const long long*>(idx),
      static_cast<float*>(out), fd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zfp_decode_blocks_fa_launch(const void* payload, const void* emax,
                                           const void* nplanes, void* out, long long nb,
                                           int num_words, void* stream) {
  if (nb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZFP_FLAT(W) launch_flat<W>(payload, emax, nplanes, out, nb, s)
  ZFP_DISPATCH_WORDS(num_words, ZFP_FLAT)
#undef ZFP_FLAT
}

// payload (n_samples, nb, num_words), emax and nplanes (n_samples, nb),
// idx (batch,) int64 -> out (batch, lead, height, width) float32, from
// samples padded to (lead, padded_height, padded_width), both multiples of 4
extern "C" int zfp_decode_blocks_fa_gather_launch(
    const void* payload, const void* emax, const void* nplanes, const void* idx, void* out,
    long long n_samples, long long batch, int nb, int num_words, int lead, int height,
    int width, int padded_height, int padded_width, void* stream) {
  if (nb <= 0 || lead <= 0 || padded_height % 4 != 0 || padded_width % 4 != 0 ||
      height <= 0 || width <= 0 || height > padded_height || width > padded_width ||
      static_cast<long long>(lead) * (padded_height / 4) * (padded_width / 4) != nb ||
      batch < 0 || batch * nb >= (1ll << 31) || n_samples < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Field fd;
  fd.n_samples = n_samples;
  fd.total = batch * nb;
  fd.nb = make_fastdiv(static_cast<uint32_t>(nb));
  fd.plane = make_fastdiv(static_cast<uint32_t>((padded_height / 4) * (padded_width / 4)));
  fd.row = make_fastdiv(static_cast<uint32_t>(padded_width / 4));
  fd.lead = lead;
  fd.height = height;
  fd.width = width;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZFP_GATHER(W) launch_gather<W>(payload, emax, nplanes, idx, out, fd, s)
  ZFP_DISPATCH_WORDS(num_words, ZFP_GATHER)
#undef ZFP_GATHER
}
