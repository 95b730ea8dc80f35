// GQA flash attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel, pallas_call at line 105): q (B, Hq, Sq, D) against k, v
// (B, Hkv, Sk, D), q head h reading KV head h / (Hq / Hkv); queries
// end-aligned with the keys (qpos = i + Sk - Sq); optional causal mask and
// sliding window (kpos > qpos - window); masked logits are the finite -1e30
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
// Bound on the H100: prefill (Sq = Sk = S, causal) does 4 B Hq D S (S+1)/2
// flops, compute bound at the tensor-core rate; decode (Sq = 1) reads each
// row's kv_lens[b] keys and values once, memory bound.
//
// Design (a first version that is right and simple; no tensor cores, no
// TMA): one CTA of 8 warps per (batch, q head, tile of q rows).  The CTA
// stages 32-key tiles of K and V in shared memory (as f32, already rounded
// to q's type; each thread issues all its loads of a tile before it stores
// any) and walks only the tiles its rows can see (the causal limit and the
// window's start bound the range).  A warp owns RPW query rows; its
// lanes split D (lane l holds dims l, l + 32, ...), and a __shfl_xor_sync
// butterfly sums each q.k, so every lane holds the same logit.  For short
// query tiles (decode) the 8 warps split each key tile instead and merge
// their (m, l, acc) through shared memory at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// strides: 12 int64 values, the (batch, head, seq) strides of q, k, v, out
// in elements.  Returns a cudaError_t (0 on success); 1 (invalid value) for
// shapes the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const void* kv_lens, int B, int Hq, int Hkv, int Sq,
                                      int Sk, int D, const long long* strides, int causal,
                                      int window, float scale, int q_bf16, int kv_bf16,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 32 * MAX_DPL || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return kv_bf16 ? launch_types<__nv_bfloat16, __nv_bfloat16>(p, rpw, st)
                   : launch_types<__nv_bfloat16, float>(p, rpw, st);
  return kv_bf16 ? launch_types<float, __nv_bfloat16>(p, rpw, st)
                 : launch_types<float, float>(p, rpw, st);
}
