// Channel layer norm + LeakyReLU on NCHW float32: one forward pass and one
// backward pass (plus a small per-channel reduction) for the surrogate's
// five blocks leaky_relu(layernorm(x)) (models/surrogate.py).
//
// Replaces no TPU kernel: the JAX package writes the block as plain jnp
// (repro/models/nn.py layernorm, leaky_relu) and XLA fuses it into one pass
// over the activation.  Eager PyTorch ran it as about a dozen kernels
// forward (two strided means, the differences, square, rsqrt, three
// broadcast products and sums, the activation's compare, product and
// select) and replayed them through autograd, with several full-size
// intermediates saved; at 512x512 and batch 64 the blocks' inputs hold
// 788.5 M floats, so that traffic was most of the training step.
//
// Bound on the H100: memory.  Forward reads x and writes y (8 bytes a
// float) plus a mean and an rstd a pixel; backward reads dy and x and
// writes dx (12 bytes a float) plus per-channel partial sums.  About 20
// bytes a float, 15.8 GB a step at 512x512, 4.7 ms at 3.35 TB/s; the
// arithmetic (some 20 operations a float) is far under the balance point.
//
// Design.  Consecutive threads own consecutive pixels of the flattened
// (batch, pixel) axis, so each load or store of one channel is a coalesced
// row across the warp.  A pixel's C channels are split over `gy` channel
// groups (threadIdx.y), channel c = g + gy * k in group g:
//   * in registers: gy = ceil(C / cpt) and each thread keeps its <= cpt
//     values (16 forward, 4 backward, whose thread holds four arrays) in
//     registers, so x (and dy) is read once and y (and dx) written once;
//     at most 16 groups, so C <= 256 forward (every block of the
//     surrogate) and C <= 64 backward (94% of its bytes).  Per-pixel sums
//     over C are the group's register sum, then the groups' partials in
//     group order through shared memory: every thread of a pixel gets the
//     same bits.
//   * streamed, beyond: gy = 8 and each pass re-reads its channels (from
//     L1 or L2).
// The choice follows C, which the launch sees; nothing else selects it.
// Measured on the H100 at the 512x512 blocks (batch 64): forward 16 and
// backward 4 channels a thread beat 8 and 4 forward (2.34 ms against 2.53,
// 3.22) and 16, 8, 2 backward (4.82 ms against 8.08, 5.11, 6.12), and a
// streamed-only backward (5.53 ms).
//
// Arithmetic, in the plain order of the PyTorch layers (built with
// --fmad=false, so no product is contracted into an add, and denormals
// kept as PyTorch keeps them): mean = sum / C, the population variance
// from the mean (two passes, not a sum of squares), rstd = rsqrtf(var +
// eps) (torch.rsqrt's function on the card), pre = (x - mean) * rstd * g +
// b, y = pre >= 0 ? pre : slope * pre.
// The backward recomputes xhat and pre from x, mean and rstd exactly so, so
// its mask is the forward's (gradient 1 at exactly 0, as in JAX), and
//   dpre = pre >= 0 ? dy : slope * dy,  dxhat = dpre * g,
//   dx = rstd * (dxhat - sum(dxhat) / C - xhat * sum(dxhat * xhat) / C).
// dg = sum(dpre * xhat) and db = sum(dpre) over the batch's pixels: each
// block writes its partials to a (2, C, blocks) scratch (a thread walks 8
// pixels, a warp sums by a fixed butterfly, the block's warps in order), and
// a second launch adds each row in double, strided then by a tree.  No
// atomics: a call gives the same bits every time.
#include <cuda_runtime.h>

namespace {

constexpr int kFwdCpt = 16;                    // channels a forward thread keeps in registers
constexpr int kBwdCpt = 4;                     // ... and a backward thread
constexpr int kItems = 8;                      // pixels a backward thread walks
constexpr int kMaxGroups = 16;                 // channel groups a pixel, in registers
constexpr int kStreamGroups = 8;               // beyond: channel groups, values re-read
constexpr int kMaxThreads = 512;
constexpr int kReduceThreads = 256;

struct Layout {
  int gy, px;                                  // channel groups, pixels a block (x)
  bool registers;                              // values kept in registers
};

Layout layout(int C, int cpt) {
  if (C > cpt * kMaxGroups) return {kStreamGroups, 32, false};
  const int gy = (C + cpt - 1) / cpt;
  return {gy, 32 * (gy < 8 ? 8 / gy : 1), true};
}

long long pixels_per_backward_block(int C) {
  const Layout l = layout(C, kBwdCpt);
  return l.registers ? static_cast<long long>(l.px) * kItems : l.px;
}

__device__ __forceinline__ long long pixel_base(long long q, long long hw, int C) {
  const long long n = q / hw;
  return n * C * hw + (q - n * hw);
}

// Sum v over the channel groups of this thread's pixel, group by group.
__device__ __forceinline__ float group_sum(float v, float* red) {
  if (blockDim.y == 1) return v;
  red[threadIdx.y * blockDim.x + threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  for (int g = 0; g < static_cast<int>(blockDim.y); ++g) s += red[g * blockDim.x + threadIdx.x];
  __syncthreads();
  return s;
}

__device__ __forceinline__ void group_sum2(float& a, float& b, float* red_a, float* red_b) {
  if (blockDim.y == 1) return;
  const int i = threadIdx.y * blockDim.x + threadIdx.x;
  red_a[i] = a;
  red_b[i] = b;
  __syncthreads();
  a = b = 0.f;
  for (int g = 0; g < static_cast<int>(blockDim.y); ++g) {
    a += red_a[g * blockDim.x + threadIdx.x];
    b += red_b[g * blockDim.x + threadIdx.x];
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float activate(float pre, float slope) {
  return pre >= 0.f ? pre : slope * pre;
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(kMaxThreads)
fwd_registers(const float* __restrict__ x, const float* __restrict__ gam,
              const float* __restrict__ bet, float* __restrict__ y,
              float* __restrict__ mean, float* __restrict__ rstd,
              long long P, long long hw, int C, float eps, float slope) {
  __shared__ float red[kMaxThreads];
  const int gy = blockDim.y, g = threadIdx.y;
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = q < P;
  const long long base = live ? pixel_base(q, hw, C) : 0;
  float v[kFwdCpt];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kFwdCpt; ++k) {
    const int c = g + gy * k;
    v[k] = (live && c < C) ? x[base + c * hw] : 0.f;
    if (c < C) s += v[k];
  }
  const float mu = group_sum(s, red) / static_cast<float>(C);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kFwdCpt; ++k) {
    const int c = g + gy * k;
    if (c < C) {
      const float d = v[k] - mu;
      ss += d * d;
    }
  }
  const float var = group_sum(ss, red) / static_cast<float>(C);
  const float rs = rsqrtf(var + eps);
  if (!live) return;
#pragma unroll
  for (int k = 0; k < kFwdCpt; ++k) {
    const int c = g + gy * k;
    if (c < C) y[base + c * hw] = activate((v[k] - mu) * rs * __ldg(gam + c) + __ldg(bet + c), slope);
  }
  if (g == 0 && mean != nullptr) {
    mean[q] = mu;
    rstd[q] = rs;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fwd_streamed(const float* __restrict__ x, const float* __restrict__ gam,
             const float* __restrict__ bet, float* __restrict__ y,
             float* __restrict__ mean, float* __restrict__ rstd,
             long long P, long long hw, int C, float eps, float slope) {
  __shared__ float red[kMaxThreads];
  const int gy = blockDim.y, g = threadIdx.y;
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = q < P;
  const long long base = live ? pixel_base(q, hw, C) : 0;
  float s = 0.f;
  if (live)
    for (int c = g; c < C; c += gy) s += x[base + c * hw];
  const float mu = group_sum(s, red) / static_cast<float>(C);
  float ss = 0.f;
  if (live)
    for (int c = g; c < C; c += gy) {
      const float d = x[base + c * hw] - mu;
      ss += d * d;
    }
  const float var = group_sum(ss, red) / static_cast<float>(C);
  const float rs = rsqrtf(var + eps);
  if (!live) return;
  for (int c = g; c < C; c += gy)
    y[base + c * hw] = activate((x[base + c * hw] - mu) * rs * __ldg(gam + c) + __ldg(bet + c), slope);
  if (g == 0 && mean != nullptr) {
    mean[q] = mu;
    rstd[q] = rs;
  }
}

// --------------------------------------------------------------- backward

// part is (2, C, gridDim.x): row c holds the blocks' sums of dpre * xhat,
// row C + c those of dpre.
__global__ void __launch_bounds__(kMaxThreads)
bwd_registers(const float* __restrict__ dy, const float* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ gam, const float* __restrict__ bet,
              float* __restrict__ dx, float* __restrict__ part,
              long long P, long long hw, int C, float slope) {
  __shared__ float red[2][kMaxThreads];
  __shared__ float wpart[2][kMaxThreads / 32 * kBwdCpt];
  const int gy = blockDim.y, px = blockDim.x, g = threadIdx.y;
  float acc_g[kBwdCpt], acc_b[kBwdCpt];
#pragma unroll
  for (int k = 0; k < kBwdCpt; ++k) acc_g[k] = acc_b[k] = 0.f;
  for (int it = 0; it < kItems; ++it) {
    const long long q = (static_cast<long long>(blockIdx.x) * kItems + it) * px + threadIdx.x;
    const bool live = q < P;
    const long long base = live ? pixel_base(q, hw, C) : 0;
    const float mu = live ? mean[q] : 0.f;
    const float rs = live ? rstd[q] : 0.f;
    float xh[kBwdCpt], dxh[kBwdCpt];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdCpt; ++k) {
      const int c = g + gy * k;
      xh[k] = dxh[k] = 0.f;
      if (live && c < C) {
        const float gc = __ldg(gam + c);
        const float xhat = (x[base + c * hw] - mu) * rs;
        const float pre = xhat * gc + __ldg(bet + c);
        const float d = dy[base + c * hw];
        const float dpre = pre >= 0.f ? d : slope * d;
        const float dxhat = dpre * gc;
        xh[k] = xhat;
        dxh[k] = dxhat;
        s1 += dxhat;
        s2 += dxhat * xhat;
        acc_g[k] += dpre * xhat;
        acc_b[k] += dpre;
      }
    }
    group_sum2(s1, s2, red[0], red[1]);
    if (live) {
      const float m1 = s1 / static_cast<float>(C), m2 = s2 / static_cast<float>(C);
#pragma unroll
      for (int k = 0; k < kBwdCpt; ++k) {
        const int c = g + gy * k;
        if (c < C) dx[base + c * hw] = rs * (dxh[k] - m1 - xh[k] * m2);
      }
    }
  }
  // the block's per-channel partials: each warp's by a butterfly, then the
  // warps of a channel group in order
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = px >> 5;
#pragma unroll
  for (int k = 0; k < kBwdCpt; ++k) {
    const float a = warp_sum(acc_g[k]), b = warp_sum(acc_b[k]);
    if (lane == 0) {
      wpart[0][(w * gy + g) * kBwdCpt + k] = a;
      wpart[1][(w * gy + g) * kBwdCpt + k] = b;
    }
  }
  __syncthreads();
  const long long nblk = gridDim.x;
  for (int c = threadIdx.y * px + threadIdx.x; c < C; c += px * gy) {
    const int cg = c % gy, ck = c / gy;
    float a = 0.f, b = 0.f;
    for (int ww = 0; ww < nw; ++ww) {
      a += wpart[0][(ww * gy + cg) * kBwdCpt + ck];
      b += wpart[1][(ww * gy + cg) * kBwdCpt + ck];
    }
    part[static_cast<long long>(c) * nblk + blockIdx.x] = a;
    part[static_cast<long long>(C + c) * nblk + blockIdx.x] = b;
  }
}

// blockDim (32, gy): a warp is one channel group of 32 pixels, so its
// butterfly sum is the block's partial of each of its channels.
__global__ void __launch_bounds__(kMaxThreads)
bwd_streamed(const float* __restrict__ dy, const float* __restrict__ x,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ gam, const float* __restrict__ bet,
             float* __restrict__ dx, float* __restrict__ part,
             long long P, long long hw, int C, float slope) {
  __shared__ float red[2][kMaxThreads];
  const int gy = blockDim.y, g = threadIdx.y;
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = q < P;
  const long long base = live ? pixel_base(q, hw, C) : 0;
  const float mu = live ? mean[q] : 0.f;
  const float rs = live ? rstd[q] : 0.f;
  float s1 = 0.f, s2 = 0.f;
  if (live)
    for (int c = g; c < C; c += gy) {
      const float gc = __ldg(gam + c);
      const float xhat = (x[base + c * hw] - mu) * rs;
      const float pre = xhat * gc + __ldg(bet + c);
      const float d = dy[base + c * hw];
      const float dxhat = (pre >= 0.f ? d : slope * d) * gc;
      s1 += dxhat;
      s2 += dxhat * xhat;
    }
  group_sum2(s1, s2, red[0], red[1]);
  const float m1 = s1 / static_cast<float>(C), m2 = s2 / static_cast<float>(C);
  const long long nblk = gridDim.x;
  for (int c = g; c < C; c += gy) {
    float pg = 0.f, pb = 0.f;
    if (live) {
      const float gc = __ldg(gam + c);
      const float xhat = (x[base + c * hw] - mu) * rs;
      const float pre = xhat * gc + __ldg(bet + c);
      const float d = dy[base + c * hw];
      const float dpre = pre >= 0.f ? d : slope * d;
      const float dxhat = dpre * gc;
      dx[base + c * hw] = rs * (dxhat - m1 - xhat * m2);
      pg = dpre * xhat;
      pb = dpre;
    }
    pg = warp_sum(pg);
    pb = warp_sum(pb);
    if (threadIdx.x == 0) {
      part[static_cast<long long>(c) * nblk + blockIdx.x] = pg;
      part[static_cast<long long>(C + c) * nblk + blockIdx.x] = pb;
    }
  }
}

// One block a row of part: dg[c] (rows < C) or db[c] (rows >= C), summed in
// double, each thread over a stride, then a tree.
__global__ void __launch_bounds__(kReduceThreads)
bwd_reduce(const float* __restrict__ part, float* __restrict__ dg, float* __restrict__ db,
           long long nblk, int C) {
  __shared__ double red[kReduceThreads];
  const int r = blockIdx.x;
  const float* row = part + static_cast<long long>(r) * nblk;
  double s = 0.0;
  for (long long i = threadIdx.x; i < nblk; i += kReduceThreads) s += static_cast<double>(row[i]);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (static_cast<int>(threadIdx.x) < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float v = static_cast<float>(red[0]);
    if (r < C) dg[r] = v;
    else db[r - C] = v;
  }
}

}  // namespace

// Blocks of the backward launch for P pixels of C channels: the partial
// scratch holds 2 * C * blocks floats.
extern "C" long long ln_lrelu_backward_blocks(long long P, int C) {
  if (P <= 0 || C <= 0) return 0;
  const long long per = pixels_per_backward_block(C);
  return (P + per - 1) / per;
}

// x, y (B, C, H, W); mean, rstd (B, H, W), or both null to skip them;
// P = B * H * W, hw = H * W.
extern "C" int ln_lrelu_forward_launch(const void* x, const void* gam, const void* bet, void* y,
                                       void* mean, void* rstd, long long P, long long hw, int C,
                                       float eps, float slope, void* stream) {
  if (P <= 0 || C <= 0) return 0;
  const Layout l = layout(C, kFwdCpt);
  const dim3 block(l.px, l.gy);
  const unsigned grid = static_cast<unsigned>((P + l.px - 1) / l.px);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* gs = static_cast<const float*>(gam);
  const float* bs = static_cast<const float*>(bet);
  float* ys = static_cast<float*>(y);
  float* ms = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if (l.registers)
    fwd_registers<<<grid, block, 0, s>>>(xs, gs, bs, ys, ms, rs, P, hw, C, eps, slope);
  else
    fwd_streamed<<<grid, block, 0, s>>>(xs, gs, bs, ys, ms, rs, P, hw, C, eps, slope);
  return static_cast<int>(cudaGetLastError());
}

// dy, x, dx (B, C, H, W); mean, rstd (B, H, W) from the forward; part
// (2, C, nblk) scratch, nblk = ln_lrelu_backward_blocks(P, C); dg, db (C,).
extern "C" int ln_lrelu_backward_launch(const void* dy, const void* x, const void* mean,
                                        const void* rstd, const void* gam, const void* bet,
                                        void* dx, void* part, void* dg, void* db, long long P,
                                        long long hw, int C, long long nblk, float slope,
                                        void* stream) {
  if (P <= 0 || C <= 0) return 0;
  if (nblk != ln_lrelu_backward_blocks(P, C)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(C, kBwdCpt);
  const dim3 block(l.px, l.gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dys = static_cast<const float*>(dy);
  const float* xs = static_cast<const float*>(x);
  const float* ms = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* gs = static_cast<const float*>(gam);
  const float* bs = static_cast<const float*>(bet);
  float* dxs = static_cast<float*>(dx);
  float* ps = static_cast<float*>(part);
  if (l.registers)
    bwd_registers<<<static_cast<unsigned>(nblk), block, 0, s>>>(dys, xs, ms, rs, gs, bs, dxs, ps,
                                                                P, hw, C, slope);
  else
    bwd_streamed<<<static_cast<unsigned>(nblk), block, 0, s>>>(dys, xs, ms, rs, gs, bs, dxs, ps,
                                                               P, hw, C, slope);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_reduce<<<static_cast<unsigned>(2 * C), kReduceThreads, 0, s>>>(
      ps, static_cast<float*>(dg), static_cast<float*>(db), nblk, C);
  return static_cast<int>(cudaGetLastError());
}
