// GQA flash attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel, pallas_call at line 105): q (B, Hq, Sq, D) against k, v
// (B, Hkv, Sk, D), q head h reading KV head h / (Hq / Hkv); queries
// end-aligned with the keys (qpos = i + Sk - Sq); optional causal mask and
// sliding window (kpos > qpos - window); more queries than keys only
// without either (their alignment then changes nothing: cross-attention
// from a long decoder prompt onto a short encoder input); masked logits are the finite -1e30
// and the online softmax runs in f32 exactly as the TPU kernel's
// (m_new = max(m, max s), p = exp(s - m_new), l = exp(m - m_new) l + sum p,
// acc = exp(m - m_new) acc + p v, out = acc / max(l, 1e-30)).  A row whose
// first keys are all masked therefore adds exp(0) until a real maximum
// arrives, and exp(-1e30 - m) then wipes it, as on the TPU.
// One generalisation serves the decode path: with kv_lens, row b has
// Sk_b = kv_lens[b] keys, its queries end-aligned to Sk_b and keys at or
// past Sk_b masked.  k and v may be f32 while q is bf16 (the serving cache
// is f32); each k/v element is rounded to q's type as it is loaded, which is
// what the reference's cache.astype(q.dtype) does, without a bf16 copy.
// All four of q, k, v and out are addressed through (batch, head, seq)
// strides with a unit stride over D, so (B, S, H, D) tensors and the
// (L, B, S, Hkv, D) cache are read and written in place.
//
// Three device kernels compute that function; the caller names the one to
// launch (kernels/flash_attention.py select_variant, a rule on dtypes,
// shapes, strides and alignment) and a variant whose preconditions fail
// returns an error instead of running another:
//
// * attn_prefill_wgmma (prefill, Sq > 8, bf16 q/k/v, D 64 or 128, no
//   kv_lens, 16-byte aligned rows).  Bound by operations: a causal prefill
//   does 4 B Hq D S (S+1)/2 flops at the tensor cores' bf16 rate.  One CTA
//   per (q head, batch, 64 q rows), two CTAs per SM; the first half of the
//   launch order walks the causal q tiles heaviest first and the second
//   half lightest first, so the two CTAs sharing an SM in a one-wave launch
//   carry about the same work.  A producer warp issues TMA loads (tensor
//   maps made on the host from the real strides, 128-byte swizzle) of Q
//   once and of 64-key K and V tiles into two 2-stage rings completing on
//   mbarriers (K and V separate, so a tile's K is refilled as soon as S has
//   read it).  The consumer warpgroup runs S = Q K^T with wgmma (both
//   operands in shared memory, K-major) and O += P V with wgmma (P rounded
//   to bf16 as the register A operand, V read MN-major), overlapped
//   FA3-style: S and the online softmax of tile t run while P V of tile
//   t - 1 is in flight, and P V's inputs are written only after it
//   completes (writing them earlier makes ptxas serialise the wgmmas).  The
//   softmax is the TPU kernel's in base 2 (scale * log2 e folded into the
//   logits, ex2.approx), with the position mask only on diagonal,
//   window-edge and ragged tiles.  bf16 P is the one numeric change against
//   the scalar kernel: the TPU kernel's f32 dot_general at default
//   precision runs on the MXU with bf16 operands, so bf16 P is what the TPU
//   computes on its own hardware.
// * attn_decode_splitkv + attn_decode_merge (decode, Sq <= 8, q f32 or
//   bf16, k/v f32 or bf16, D <= 128, kv_lens or not).  Bound by bytes: each
//   row reads its kv_lens[b] keys and values once.  Grid (B, Hkv, splits):
//   a CTA holds all group = Hq / Hkv query heads (x Sq rows) of one KV head
//   (up to 8 rows; more split into row blocks along the grid's y), so each
//   key and value is read from device memory once per GQA group.  A CTA
//   walks one split of the keys (splits chosen on the host from the cache
//   capacity Sk so that the grid has two CTAs per SM) in 32-key tiles,
//   loaded with coalesced 16-byte cp.async into a 2-stage shared-memory ring
//   (the next tile in flight while this one is used); each warp takes 4
//   keys of every tile for every row with scalar FMAs (the work is about
//   0.5 FMA per byte) and keeps its own online softmax; the 8 warps merge
//   in shared memory into the split's (m, l, acc), and a second small
//   kernel merges the splits: out = sum e^(m_i - M) acc_i /
//   max(sum e^(m_i - M) l_i, 1e-30).  Its partial entry serves one shard of
//   a cache whose sequence is split over ranks: q_shift moves every query
//   position past the shard's last key, and the merge writes f32 out and
//   each row's log-sum-exp, for the caller to merge the shards.
// * attn_kernel (the first, scalar design) for everything else: f32 q with
//   long queries (TF32 tensor cores would not meet the f32 tolerance),
//   head dims other than 64 and 128, f32 k/v with long queries, rows not
//   16-byte aligned.  One CTA of 8 warps per (batch, q head, tile of q
//   rows) stages 32-key tiles of K and V in shared memory (as f32, already
//   rounded to q's type) and walks only the tiles its rows can see; a warp
//   owns RPW query rows, its lanes split D and a __shfl_xor_sync butterfly
//   sums each q.k.  For short query tiles the 8 warps split each key tile
//   instead and merge their (m, l, acc) through shared memory at the end.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 32;      // keys per shared-memory tile
constexpr int CHUNK = 4;    // keys per online-softmax update
constexpr int MAX_DPL = 4;  // D <= 128
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to the precision of T and back to f32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* kv_lens;  // (B,) or null
  int B, Hq, Hkv, Sq, Sk, D;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, seq) strides, elements
  int causal, window;                    // window <= 0: none
  float scale;
  int bq, splits;                        // q rows per CTA; warps per row group
};

template <typename TQ, typename TKV, int DPL, int RPW>
__global__ void __launch_bounds__(THREADS) attn_kernel(const Params p) {
  constexpr int DP = 32 * DPL;
  constexpr int LPT = BK * DP / THREADS;  // K (and V) elements a thread stages per tile
  __shared__ float ks[BK][DP];
  __shared__ float vs[BK][DP];
  __shared__ float red[WARPS][DP + 2];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const int i0 = blockIdx.x * p.bq;
  const int split = warp % p.splits, rg = warp / p.splits;
  const int seq_k = p.kv_lens ? min(max(p.kv_lens[b], 0), p.Sk) : p.Sk;
  const int off = seq_k - p.Sq;  // qpos = i + off
  const TQ* q = static_cast<const TQ*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const TKV* k = static_cast<const TKV*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const TKV* v = static_cast<const TKV*>(p.v) + b * p.vs[0] + hk * p.vs[1];

  float qr[RPW][DPL], acc[RPW][DPL], m[RPW], l[RPW];
  int qpos[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + rg * RPW + r;
    qpos[r] = i + off;
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      qr[r][c] = (i < p.Sq && d < p.D) ? to_f32(q[i * p.qs[2] + d]) : 0.f;
      acc[r][c] = 0.f;
    }
  }

  // the keys any row of this CTA can see
  const int i_last = min(i0 + p.bq, p.Sq) - 1;
  const int k_hi = p.causal ? min(seq_k, i_last + off + 1) : seq_k;
  int k_lo = p.window > 0 ? max(0, i0 + off - p.window + 1) : 0;
  k_lo = (k_lo / BK) * BK;
  const int per = BK / p.splits;  // keys of each tile this warp handles

  for (int t0 = k_lo; t0 < k_hi; t0 += BK) {
    // every load of the tile is issued before the first store, so a tile
    // costs one memory latency, not one per element a thread stages
    float kreg[LPT], vreg[LPT];
#pragma unroll
    for (int it = 0; it < LPT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int d = e % DP, kp = t0 + e / DP;
      const bool ok = kp < seq_k && d < p.D;
      kreg[it] = ok ? to_f32(k[kp * p.ks[2] + d]) : 0.f;
      vreg[it] = ok ? to_f32(v[kp * p.vs[2] + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < LPT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      ks[e / DP][e % DP] = round_to<TQ>(kreg[it]);
      vs[e / DP][e % DP] = round_to<TQ>(vreg[it]);
    }
    __syncthreads();

    for (int j0 = split * per; j0 < (split + 1) * per; j0 += CHUNK) {
      float s[RPW][CHUNK];
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        float kk[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) kk[c] = ks[j0 + jj][lane + 32 * c];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < DPL; ++c) part = fmaf(qr[r][c], kk[c], part);
          s[r][jj] = part;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int jj = 0; jj < CHUNK; ++jj)
            s[r][jj] += __shfl_xor_sync(FULL, s[r][jj], o);
      }
      float pr[RPW][CHUNK];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float m_cur = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < CHUNK; ++jj) {
          const int kp = t0 + j0 + jj;
          bool ok = kp < seq_k;
          if (p.causal) ok = ok && kp <= qpos[r];
          if (p.window > 0) ok = ok && kp > qpos[r] - p.window;
          s[r][jj] = ok ? s[r][jj] * p.scale : NEG_INF;
          m_cur = fmaxf(m_cur, s[r][jj]);
        }
        const float m_new = fmaxf(m[r], m_cur);
        const float alpha = expf(m[r] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int jj = 0; jj < CHUNK; ++jj) {
          pr[r][jj] = expf(s[r][jj] - m_new);
          psum += pr[r][jj];
        }
        l[r] = alpha * l[r] + psum;
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        float vv[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) vv[c] = vs[j0 + jj][lane + 32 * c];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pr[r][jj], vv[c], acc[r][c]);
      }
    }
  }

  if (p.splits > 1) {  // RPW == 1: merge the warps that split the keys
#pragma unroll
    for (int c = 0; c < DPL; ++c) red[warp][lane + 32 * c] = acc[0][c];
    if (lane == 0) {
      red[warp][DP] = m[0];
      red[warp][DP + 1] = l[0];
    }
    __syncthreads();
    if (split != 0) return;
    float mt = NEG_INF;
    for (int sp = 0; sp < p.splits; ++sp) mt = fmaxf(mt, red[warp + sp][DP]);
    float lt = 0.f, at[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) at[c] = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float w = expf(red[warp + sp][DP] - mt);
      lt += w * red[warp + sp][DP + 1];
#pragma unroll
      for (int c = 0; c < DPL; ++c) at[c] = fmaf(w, red[warp + sp][lane + 32 * c], at[c]);
    }
    l[0] = lt;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[0][c] = at[c];
  }

  TQ* o = static_cast<TQ*>(p.out) + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + rg * RPW + r;
    if (i >= p.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D) o[i * p.os[2] + d] = from_f32<TQ>(acc[r][c] / denom);
    }
  }
}

template <typename TQ, typename TKV, int DPL>
int launch_dpl(const Params& p, int rpw, cudaStream_t stream) {
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.Hq, p.B);
  if (rpw == 4)
    attn_kernel<TQ, TKV, DPL, 4><<<grid, THREADS, 0, stream>>>(p);
  else
    attn_kernel<TQ, TKV, DPL, 1><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_types(const Params& p, int rpw, cudaStream_t stream) {
  if (p.D <= 32) return launch_dpl<TQ, TKV, 1>(p, rpw, stream);
  if (p.D <= 64) return launch_dpl<TQ, TKV, 2>(p, rpw, stream);
  return launch_dpl<TQ, TKV, MAX_DPL>(p, rpw, stream);
}

// ---------------------------------------------------------------------------
// PTX helpers: shared-memory addresses, mbarriers, TMA, cp.async, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of wgmma accumulators across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor for a tile stored as 128-byte rows with
// the 128-byte swizzle TMA writes (8-row atoms of 1,024 bytes, 1,024-byte
// aligned): start address, leading and stride byte offsets in 16-byte
// units, layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (m64 x n64, f32) (+)= A (m64 x k16, shared, K-major) * B (k16 x n64,
// shared, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64 x n64, f32) += A (m64 x k16 bf16, registers) * B (k16 x n64,
// shared, MN-major: the transposed-B layout of 16-bit types)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// 2^x with the MUFU unit's approximation (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// attn_prefill_wgmma
// ---------------------------------------------------------------------------

constexpr int PF_BM = 64;      // q rows per CTA: one consumer warpgroup
constexpr int PF_BN = 64;      // keys per K/V tile
constexpr int PF_THREADS = 128 + 32;  // the consumer warpgroup and the producer warp
constexpr int PF_STAGES = 2;   // depth of the K ring and of the V ring
constexpr int PF_ROW = 128;    // bytes of one swizzled smem row (64 bf16)
constexpr float LOG2E = 1.4426950408889634f;

struct PrefillParams {
  void* out;
  int B, Hq, Hkv, Sq, Sk, group;
  long long os[3];
  int causal, window;
  float scale_log2;                           // sm_scale * log2(e)
  int q_seq_inner, k_seq_inner, v_seq_inner;  // tensor-map dim order: (D, S, H, B) if 1
};

constexpr int prefill_smem_bytes(int d) {
  return 1024 + (d / 64) * (PF_BM + 2 * PF_STAGES * PF_BN) * PF_ROW + 8 * (4 * PF_STAGES + 1);
}

// tensor-map coordinates (d, head, seq, batch) in the map's dim order
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int seq_inner, int d, int h, int s, int b) {
  if (seq_inner)
    tma_load_4d(dst, map, bar, d, s, h, b);
  else
    tma_load_4d(dst, map, bar, d, h, s, b);
}

template <int D>
__global__ void __launch_bounds__(PF_THREADS, 1)
    attn_prefill_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const PrefillParams p) {
  constexpr int S = PF_STAGES;
  constexpr int BM = PF_BM;
  constexpr int NH = D / 64;     // 64-wide column halves of a row
  constexpr uint32_t QH = BM * PF_ROW, KH = PF_BN * PF_ROW;  // bytes of one half
  constexpr uint32_t KSTAGE = NH * KH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t sk = sq + NH * QH;
  const uint32_t sv = sk + S * KSTAGE;
  // mbarriers: K full, V full, K empty, V empty (S each), then Q
  const uint32_t bars = sv + S * KSTAGE;
  const uint32_t qbar = bars + 32 * S;
  auto kfull = [&](int t) { return bars + 8 * (t % S); };
  auto vfull = [&](int t) { return bars + 8 * (S + t % S); };
  auto kempty = [&](int t) { return bars + 8 * (2 * S + t % S); };
  auto vempty = [&](int t) { return bars + 8 * (3 * S + t % S); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / p.group;
  const int off = p.Sk - p.Sq;  // qpos = i + off
  // this CTA's q tile: the first half of the launch order walks the causal
  // tiles heaviest first, the second half lightest first, so the two CTAs
  // that share an SM in a one-wave launch carry about the same work
  const int nq = gridDim.z, z = blockIdx.z;
  const int i0 = (2 * z >= nq ? z - (nq + 1) / 2 : nq - 1 - z) * BM;
  const int i_last = min(i0 + BM, p.Sq) - 1;
  // the keys its rows see
  const int k_hi = p.causal ? min(p.Sk, i_last + off + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, i0 + off - p.window + 1) : 0;
  const int t_lo = k_lo / PF_BN;
  const int ntiles = max((k_hi + PF_BN - 1) / PF_BN - t_lo, 0);

  if (threadIdx.x == 0) {
    for (int t = 0; t < S; ++t) {
      mbar_init(kfull(t), 1);         // the producer's expect_tx
      mbar_init(vfull(t), 1);
      mbar_init(kempty(t), 4);  // one arrival per consumer warp
      mbar_init(vempty(t), 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4) {
    // producer: Q once, then the K and V rings
    if (lane == 0) {
      mbar_expect_tx(qbar, NH * QH);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        tma_rows(sq + hh * QH, &tq, qbar, p.q_seq_inner, hh * 64, h, i0, b);
      for (int t = 0; t < ntiles; ++t) {
        const uint32_t parity = ((t / S) & 1) ^ 1, st = (t % S) * KSTAGE;
        const int kp = (t_lo + t) * PF_BN;
        mbar_wait(kempty(t), parity);
        mbar_expect_tx(kfull(t), KSTAGE);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          tma_rows(sk + st + hh * KH, &tk, kfull(t), p.k_seq_inner, hh * 64, hk, kp, b);
        mbar_wait(vempty(t), parity);
        mbar_expect_tx(vfull(t), KSTAGE);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          tma_rows(sv + st + hh * KH, &tv, vfull(t), p.v_seq_inner, hh * 64, hk, kp, b);
      }
    }
    return;
  }

  // the consumer warpgroup: q rows i0 .. i0 + 63, warp w rows 16 w .. 16 w + 15;
  // a lane holds rows a and b, 16 columns of each tile
  const int row_a = i0 + 16 * warp + (lane >> 2), row_b = row_a + 8;
  const int qpos_a = row_a + off, qpos_b = row_b + off;
  const int cq = 2 * (lane & 3);  // this lane's first column in each 8-column group

  float o[NH][32];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  // running maxima in log2 units, and this lane's partial row sums
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float sc[32];                    // S of a tile, then its P in f32
  uint32_t pa[PF_BN / 16][4];      // P in bf16: the A operand of P V
  float al_a = 1.f, al_b = 1.f;    // the factors that rescale O

  auto wait = [&](uint32_t bar, int t) { mbar_wait(bar, (t / S) & 1); };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // S = Q K^T over D in k16 steps (issued, not waited for); the k-step
  // advances the descriptors 32 bytes inside the 128-byte swizzle atom
  auto issue_s = [&](int t) {
    const uint32_t ks = sk + (t % S) * KSTAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk / 4) * QH + (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(sq + step, 16, 1024),
               sw128_desc(ks + (kk / 4) * KH + (kk % 4) * 32, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V over the tile's keys in k16 steps, per 64-wide half of D
  auto issue_pv = [&](int t) {
    const uint32_t vs = sv + (t % S) * KSTAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PF_BN / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        wgmma_rs(o[hh], pa[kk], sw128_desc(vs + hh * KH + kk * 16 * PF_ROW, 1024, 1024));
    wgmma_commit();
  };
  // the online softmax of tile t's scores in sc, in place: new maxima, row
  // sums, P (f32) and the factors al_a, al_b that rescale O
  auto softmax = [&](int t) {
    const int kp0 = (t_lo + t) * PF_BN, kp_last = kp0 + PF_BN - 1;
    bool whole = kp_last < p.Sk;  // no key of the tile is masked for any row
    if (p.causal) whole = whole && kp_last <= i0 + off;
    if (p.window > 0) whole = whole && kp0 > i_last + off - p.window;
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * p.scale_log2;
        if (!whole) {
          const int kp = kp0 + 8 * j + cq + (e & 1);
          const int qp = e < 2 ? qpos_a : qpos_b;
          bool ok = kp < p.Sk;
          if (p.causal) ok = ok && kp <= qp;
          if (p.window > 0) ok = ok && kp > qp - p.window;
          x = ok ? x : NEG_INF;
        }
        sc[4 * j + e] = x;
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    al_a = ex2(m_a - mn_a);
    al_b = ex2(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = ex2(sc[4 * j] - mn_a);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn_a);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn_b);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn_b);
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_a = al_a * l_a + sum_a;
    l_b = al_b * l_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
  };
  // P to bf16: the S accumulator's columns 16kk .. 16kk + 15 are the A
  // operand of P V's k-step kk, registers (row a, lo), (row b, lo), (a, hi), (b, hi)
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j / 2][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[hh][4 * j] *= al_a;
        o[hh][4 * j + 1] *= al_a;
        o[hh][4 * j + 2] *= al_b;
        o[hh][4 * j + 3] *= al_b;
      }
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(o[hh]);
  };


  mbar_wait(qbar, 0);
  if (ntiles > 0) {
    int t = 0;
    // S of tile t and its softmax run while P V of tile t - 1 is in flight;
    // P V's inputs (pa, o) are written only once it has completed
    wait(kfull(t), t);
    issue_s(t);
    wgmma_wait0();
    fence_regs(sc);
    release(kempty(t));
    softmax(t);
    pack_p();
    for (++t; t < ntiles; ++t) {
      rescale();  // by tile t - 1's factors, before its P V
      wait(kfull(t), t);
      issue_s(t);
      wait(vfull(t - 1), t - 1);
      issue_pv(t - 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S done
      fence_regs(sc);
      release(kempty(t));
      softmax(t);
      wgmma_wait0();  // P V of tile t - 1 done
      fence_o();
      release(vempty(t - 1));
      pack_p();
    }
    rescale();
    wait(vfull(t - 1), t - 1);
    issue_pv(t - 1);
    wgmma_wait0();
    fence_o();
    release(vempty(t - 1));
  }

  // epilogue: out = acc / max(l, 1e-30) (one division per row, then
  // products), bf16, in the layout wo reads
  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = hh * 64 + 8 * j + cq;
      if (row_a < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + row_a * p.os[2] + d) =
            __floats2bfloat162_rn(o[hh][4 * j] * inv_a, o[hh][4 * j + 1] * inv_a);
      if (row_b < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + row_b * p.os[2] + d) =
            __floats2bfloat162_rn(o[hh][4 * j + 2] * inv_b, o[hh][4 * j + 3] * inv_b);
    }
}

// ---------------------------------------------------------------------------
// attn_decode_splitkv + attn_decode_merge
// ---------------------------------------------------------------------------

constexpr int DEC_TILE = 32;          // keys per ring stage: 4 per warp
constexpr int DEC_STAGES = 2;         // ring depth: the next tile in flight while one is used
constexpr int DEC_ROWS = 8;           // query rows (group x Sq) a CTA holds at most
constexpr int DEC_MAX_ROWS = 64;      // group x Sq rows the variant takes

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_lens;  // (B,) or null
  float* ml;           // (2, B, Hq, Sq, splits): m, then l
  float* acc;          // (B, Hq, Sq, splits, D)
  float* lse;          // (B, Hq, Sq) or null: see attn_decode_merge
  int B, Hq, Hkv, Sq, Sk, D, group, rows, row_blocks, splits, split_keys;
  int q_shift;         // added to every query position (0: end-aligned)
  long long qs[3], ks[3], vs[3];
  int causal, window;
  float scale;
};

// the K/V ring, reused at the end for the warps' states (stride D + 4 floats)
template <typename TKV>
constexpr int decode_smem_bytes(int d) {
  return 2 * DEC_STAGES * DEC_TILE * d * static_cast<int>(sizeof(TKV)) >
                 WARPS * DEC_ROWS * (d + 4) * 4
             ? 2 * DEC_STAGES * DEC_TILE * d * static_cast<int>(sizeof(TKV))
             : WARPS * DEC_ROWS * (d + 4) * 4;
}

// 4 consecutive elements of a shared-memory row, as f32 rounded to TQ
template <typename TQ>
__device__ __forceinline__ void load4(const float* src, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  x[0] = round_to<TQ>(v.x);
  x[1] = round_to<TQ>(v.y);
  x[2] = round_to<TQ>(v.z);
  x[3] = round_to<TQ>(v.w);
}
template <typename TQ>
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = round_to<TQ>(__low2float(lo));
  x[1] = round_to<TQ>(__high2float(lo));
  x[2] = round_to<TQ>(__low2float(hi));
  x[3] = round_to<TQ>(__high2float(hi));
}

// One CTA per (batch row, KV head x row block, split): the rows are the
// block's query heads of the GQA group times Sq (all of them while group x
// Sq <= DEC_ROWS, which every serving decode is), so each key and value is
// read from device memory once per group.  Warp w owns keys 4w .. 4w + 3 of
// every tile and keeps its own online softmax (m, l, acc) for every row;
// lane l holds dims 4l .. 4l + 3.  The 8 warps' states merge in shared
// memory at the end into the split's partial.
template <typename TQ, typename TKV, int RPB>
__global__ void __launch_bounds__(THREADS) attn_decode_splitkv(const DecodeParams p) {
  extern __shared__ __align__(16) unsigned char smem_dec[];
  const int D = p.D;
  TKV* kst = reinterpret_cast<TKV*>(smem_dec);            // [STAGES][DEC_TILE][D]
  TKV* vst = kst + DEC_STAGES * DEC_TILE * D;             // [STAGES][DEC_TILE][D]

  const int b = blockIdx.x, split = blockIdx.z;
  const int hk = blockIdx.y / p.row_blocks;
  const int r0 = (blockIdx.y % p.row_blocks) * DEC_ROWS;  // first row of this block
  const int nr = min(p.rows - r0, RPB);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seq_k = p.kv_lens ? min(max(p.kv_lens[b], 0), p.Sk) : p.Sk;
  const int off = seq_k - p.Sq + p.q_shift;
  // this split's keys that any row can see (the last row sees up to seq_k)
  int lo = split * p.split_keys;
  const int hi = min(lo + p.split_keys, seq_k);
  if (p.window > 0) lo = max(lo, off - p.window + 1);
  const int ntiles = hi > lo ? (hi - lo + DEC_TILE - 1) / DEC_TILE : 0;

  const TKV* kb = static_cast<const TKV*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const TKV* vb = static_cast<const TKV*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  const int cpr = D * static_cast<int>(sizeof(TKV)) / 16;  // 16-byte chunks per row
  const uint32_t kst_u = smem_u32(kst), vst_u = smem_u32(vst);
  const int row_bytes = D * static_cast<int>(sizeof(TKV));

  // one commit group per tile (empty past the last), coalesced 16-byte copies
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int stage = tile % DEC_STAGES, k0 = lo + tile * DEC_TILE;
      for (int c = threadIdx.x; c < DEC_TILE * cpr; c += THREADS) {
        const int j = c / cpr, part = c - j * cpr, kp = k0 + j;
        const bool ok = kp < hi;
        const uint32_t dst = (stage * DEC_TILE + j) * row_bytes + part * 16;
        const char* ks = reinterpret_cast<const char*>(ok ? kb + kp * p.ks[2] : kb) + part * 16;
        const char* vs = reinterpret_cast<const char*>(ok ? vb + kp * p.vs[2] : vb) + part * 16;
        cp_async16(kst_u + dst, ks, ok ? 16 : 0);
        cp_async16(vst_u + dst, vs, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  issue(0);

  // this lane's 4 dims of each row r0 + i = g * Sq + iq (q head hk * group + g)
  const int d0 = 4 * lane;
  const bool dok = d0 < D;
  float q[RPB][4], m[RPB], l[RPB], acc[RPB][4];
  int qpos[RPB];
  const TQ* qb = static_cast<const TQ*>(p.q) + b * p.qs[0];
#pragma unroll
  for (int i = 0; i < RPB; ++i) {
    const int r = min(r0 + i, p.rows - 1), g = r / p.Sq, iq = r - g * p.Sq;
    qpos[i] = iq + off;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q[i][c] = dok ? to_f32(qb[(hk * p.group + g) * p.qs[1] + iq * p.qs[2] + d0 + c]) : 0.f;
      acc[i][c] = 0.f;
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // tile t has landed here
    __syncthreads();  // ... for every thread, and tile t - 1's stage is free
    issue(t + 1);     // in flight while tile t is used
    const int stage = t % DEC_STAGES, kp0 = lo + t * DEC_TILE + 4 * warp;
    const TKV* kt = kst + (stage * DEC_TILE + 4 * warp) * D + d0;
    const TKV* vt = vst + (stage * DEC_TILE + 4 * warp) * D + d0;
    float kf[4][4], vf[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (dok) {
        load4<TQ>(kt + j * D, kf[j]);
        load4<TQ>(vt + j * D, vf[j]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) kf[j][c] = vf[j][c] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < RPB; ++i) {
      if (i >= nr) break;
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) x = fmaf(q[i][c], kf[j][c], x);
        s[j] = x;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] += __shfl_xor_sync(FULL, s[j], o);
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kp0 + j;
        bool ok = kp < hi;
        if (p.causal) ok = ok && kp <= qpos[i];
        if (p.window > 0) ok = ok && kp > qpos[i] - p.window;
        s[j] = ok ? s[j] * p.scale : NEG_INF;
        mt = fmaxf(mt, s[j]);
      }
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[j] - m_new);
        ps += pj;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(pj, vf[j][c], acc[i][c]);
      }
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
    }
  }

  // merge the 8 warps' states in shared memory (the ring is free by now)
  // into this split's partial: (m, l) and the unnormalised acc of each row
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_dec);  // [WARPS][RPB][D + 4]: acc, m, l
  const int stride = D + 4;
#pragma unroll
  for (int i = 0; i < RPB; ++i) {
    if (i >= nr) break;
    float* rw = red + (warp * RPB + i) * stride;
    if (dok) *reinterpret_cast<float4*>(rw + d0) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                                               acc[i][3]);
    if (lane == 0) {
      rw[D] = m[i];
      rw[D + 1] = l[i];
    }
  }
  __syncthreads();
  const long long nrows = static_cast<long long>(p.B) * p.Hq * p.Sq;
  for (int e = threadIdx.x; e < nr * D; e += THREADS) {
    const int i = e / D, d = e - i * D;
    float mt = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, red[(w * RPB + i) * stride + D]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float* rw = red + (w * RPB + i) * stride;
      const float wt = expf(rw[D] - mt);
      lt = fmaf(wt, rw[D + 1], lt);
      at = fmaf(wt, rw[d], at);
    }
    const int r = r0 + i, g = r / p.Sq, iq = r - g * p.Sq;
    const long long row = (static_cast<long long>(b) * p.Hq + hk * p.group + g) * p.Sq + iq;
    const long long part = row * p.splits + split;
    p.acc[part * D + d] = at;
    if (d == 0) {
      p.ml[part] = mt;
      p.ml[nrows * p.splits + part] = lt;
    }
  }
}

// With lse (the partial entry: out is f32 then), each row's log-sum-exp
// of its scores goes there too, NEG_INF (and out 0) for a row that saw no
// key, so that
// partials over disjoint key sets merge as sum_i e^(lse_i - M) out_i /
// sum_i e^(lse_i - M).
template <typename TQ>
__global__ void __launch_bounds__(128) attn_decode_merge(const float* ml, const float* acc,
                                                         void* out, float* lse, int Hq,
                                                         int Sq, int D, int splits,
                                                         long long nrows, long long os0,
                                                         long long os1, long long os2) {
  const long long row = blockIdx.x;
  const int iq = static_cast<int>(row % Sq);
  const int h = static_cast<int>((row / Sq) % Hq);
  const int b = static_cast<int>(row / (static_cast<long long>(Sq) * Hq));
  const float* m = ml + row * splits;
  const float* l = ml + nrows * splits + row * splits;
  float mt = NEG_INF;
  for (int s = 0; s < splits; ++s) mt = fmaxf(mt, m[s]);
  const int d = threadIdx.x;
  float lt = 0.f, o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(m[s] - mt);
    lt = fmaf(w, l[s], lt);
    if (d < D) o = fmaf(w, acc[(row * splits + s) * D + d], o);
  }
  // a row that saw no key (all its scores NEG_INF) is 0 in the partial entry
  const bool none = lse && mt == NEG_INF;
  if (d < D)
    static_cast<TQ*>(out)[b * os0 + h * os1 + iq * os2 + d] =
        from_f32<TQ>(none ? 0.f : o / fmaxf(lt, 1e-30f));
  if (lse && d == 0) lse[row] = none ? NEG_INF : mt + logf(lt);
}

template <typename TQ, typename TKV, int RPB>
int launch_decode_rpb(const DecodeParams& p, void* out, const long long* os,
                      cudaStream_t stream) {
  const int smem = decode_smem_bytes<TKV>(p.D);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_decode_splitkv<TQ, TKV, RPB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      decode_smem_bytes<TKV>(32 * MAX_DPL));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_decode_splitkv<TQ, TKV, RPB>
      <<<dim3(p.B, p.Hkv * p.row_blocks, p.splits), THREADS, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long nrows = static_cast<long long>(p.B) * p.Hq * p.Sq;
  if (p.lse)
    attn_decode_merge<float><<<static_cast<unsigned>(nrows), 128, 0, stream>>>(
        p.ml, p.acc, out, p.lse, p.Hq, p.Sq, p.D, p.splits, nrows, os[0], os[1], os[2]);
  else
    attn_decode_merge<TQ><<<static_cast<unsigned>(nrows), 128, 0, stream>>>(
        p.ml, p.acc, out, nullptr, p.Hq, p.Sq, p.D, p.splits, nrows, os[0], os[1], os[2]);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_decode(const DecodeParams& p, void* out, const long long* os, cudaStream_t stream) {
  const int rpb = min(p.rows, DEC_ROWS);
  if (rpb <= 1) return launch_decode_rpb<TQ, TKV, 1>(p, out, os, stream);
  if (rpb <= 2) return launch_decode_rpb<TQ, TKV, 2>(p, out, os, stream);
  if (rpb <= 4) return launch_decode_rpb<TQ, TKV, 4>(p, out, os, stream);
  return launch_decode_rpb<TQ, TKV, 8>(p, out, os, stream);
}

// ---------------------------------------------------------------------------
// host side of the prefill: tensor maps and launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, from the libcuda the runtime loaded
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (B, H, S, D) bf16 tensor with (batch, head, seq) strides st (elements)
// as a 4-D tensor map over (D, H, S, B), or (D, S, H, B) when the seq
// stride is the smaller one; boxes of 64 dims x `rows` rows of one head.
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D,
              const long long* st, int rows, int* seq_inner) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const bool si = st[2] < st[1];
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {0, 0, static_cast<cuuint64_t>(st[0]) * 2};
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t es[4] = {1, 1, 1, 1};
  dims[1] = si ? S : H;
  dims[2] = si ? H : S;
  strides[0] = static_cast<cuuint64_t>(si ? st[2] : st[1]) * 2;
  strides[1] = static_cast<cuuint64_t>(si ? st[1] : st[2]) * 2;
  box[si ? 1 : 2] = rows;
  *seq_inner = si;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_prefill_t(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                     const PrefillParams& p, cudaStream_t stream) {
  constexpr int smem = prefill_smem_bytes(D);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_prefill_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(p.Hq, p.B, (p.Sq + PF_BM - 1) / PF_BM);
  attn_prefill_wgmma<D><<<grid, PF_THREADS, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr, const long long* st) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st[0] % 8 == 0 && st[1] % 8 == 0 &&
         st[2] % 8 == 0;
}

int launch_prefill(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                   int Hkv, int Sq, int Sk, int D, const long long* strides, int causal,
                   int window, float scale, cudaStream_t stream) {
  if ((D != 64 && D != 128) || Sq <= 8 ||
      !aligned16(q, strides) || !aligned16(k, strides + 3) || !aligned16(v, strides + 6))
    return static_cast<int>(cudaErrorInvalidValue);
  PrefillParams p;
  p.out = out;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.group = Hq / Hkv;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * LOG2E;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Hq, Sq, D, strides, PF_BM, &p.q_seq_inner) ||
      !make_map(&tk, k, B, Hkv, Sk, D, strides + 3, PF_BN, &p.k_seq_inner) ||
      !make_map(&tv, v, B, Hkv, Sk, D, strides + 6, PF_BN, &p.v_seq_inner))
    return static_cast<int>(cudaErrorInvalidValue);
  return D == 64 ? launch_prefill_t<64>(tq, tk, tv, p, stream)
                 : launch_prefill_t<128>(tq, tk, tv, p, stream);
}

int launch_splitkv(const void* q, const void* k, const void* v, void* out, const void* kv_lens,
                   int B, int Hq, int Hkv, int Sq, int Sk, int D, const long long* strides,
                   int causal, int window, float scale, int q_bf16, int kv_bf16, void* part_ml,
                   void* part_acc, int splits, int split_keys, int q_shift, void* lse,
                   cudaStream_t stream) {
  const int kv_size = kv_bf16 ? 2 : 4;
  const bool kv_aligned = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  bool ok = Sq <= 8 && (D * kv_size) % 16 == 0 && kv_aligned &&
            (Hq / Hkv) * Sq <= DEC_MAX_ROWS && part_ml && part_acc && splits >= 1 &&
            split_keys > 0 && split_keys % DEC_TILE == 0 &&
            static_cast<long long>(splits) * split_keys >= Sk && q_shift >= 0;
  for (int i = 3; i < 9; ++i) ok = ok && (strides[i] * kv_size) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.ml = static_cast<float*>(part_ml);
  p.acc = static_cast<float*>(part_acc);
  p.lse = static_cast<float*>(lse);
  p.q_shift = q_shift;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.group = Hq / Hkv;
  p.rows = p.group * Sq;
  p.row_blocks = (p.rows + DEC_ROWS - 1) / DEC_ROWS;
  p.splits = splits;
  p.split_keys = split_keys;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
  }
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const long long* os = strides + 9;
  if (q_bf16)
    return kv_bf16 ? launch_decode<__nv_bfloat16, __nv_bfloat16>(p, out, os, stream)
                   : launch_decode<__nv_bfloat16, float>(p, out, os, stream);
  return kv_bf16 ? launch_decode<float, __nv_bfloat16>(p, out, os, stream)
                 : launch_decode<float, float>(p, out, os, stream);
}

}  // namespace

// strides: 12 int64 values, the (batch, head, seq) strides of q, k, v, out
// in elements.  variant: 0 attn_kernel (scalar), 1 attn_prefill_wgmma,
// 2 attn_decode_splitkv + merge
// (partials in part_ml (2, B, Hq, Sq, splits) and part_acc (B, Hq, Sq,
// splits, D), f32, split_keys keys per split).  q_shift and lse, taken by
// variant 2 alone (0 and null for the others): q_shift is added to every
// query's end-aligned position, and a non-null lse (B, Hq, Sq) f32 makes out
// f32 and receives each row's log-sum-exp (the partial entry: one shard of
// a sequence-sharded cache).  Returns a cudaError_t (0 on success); 1
// (invalid value) for shapes or a variant the kernels do not take.  Nothing
// is launched in place of a refused variant.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const void* kv_lens, int B, int Hq, int Hkv, int Sq,
                                      int Sk, int D, const long long* strides, int causal,
                                      int window, float scale, int q_bf16, int kv_bf16,
                                      int variant, void* part_ml,
                                      void* part_acc, int splits, int split_keys,
                                      int q_shift, void* lse, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 32 * MAX_DPL || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant != 2 && (q_shift != 0 || lse)) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 1) {
    // more queries than keys only where their alignment cannot matter:
    // non-causal without a window (cross-attention onto a short encoder input)
    if (!q_bf16 || !kv_bf16 || kv_lens || (Sk < Sq && (causal || window > 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_prefill(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, strides, causal, window, scale,
                          st);
  }
  if (variant == 2)
    return launch_splitkv(q, k, v, out, kv_lens, B, Hq, Hkv, Sq, Sk, D, strides, causal,
                          window, scale, q_bf16, kv_bf16, part_ml, part_acc, splits,
                          split_keys, q_shift, lse, st);
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  // long query tiles: 8 warps x 4 rows, each warp walking every key; short
  // ones (decode): one row per warp, the warps of a row splitting the keys
  int rpw;
  if (Sq > WARPS) {
    rpw = 4;
    p.bq = WARPS * rpw;
    p.splits = 1;
  } else {
    rpw = 1;
    p.bq = 1;
    while (p.bq < Sq) p.bq *= 2;
    p.splits = WARPS / p.bq;
  }
  if (q_bf16)
    return kv_bf16 ? launch_types<__nv_bfloat16, __nv_bfloat16>(p, rpw, st)
                   : launch_types<__nv_bfloat16, float>(p, rpw, st);
  return kv_bf16 ? launch_types<float, __nv_bfloat16>(p, rpw, st)
                 : launch_types<float, float>(p, rpw, st);
}
