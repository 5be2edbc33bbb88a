// Backward flash attention for Hopper (sm_90a): dq, dk and dv of the
// forward in flash_attention.cu.
//
// The JAX package's Pallas kernel (src/repro/kernels/flash_attention/
// flash_attention.py, _flash_kernel) has no backward: it trains through
// XLA's autodiff of its jnp attention.  The port runs every attention
// through the forward kernel, so the gradient that jax.grad gives the
// reference comes from here: the gradient of the plain version
// (ref.flash_attention_ref), for everything the forward takes (causal or
// not, a sliding window, a tanh softcap, any scale, masks by position, any
// H % KV == 0, head_dim 64, 128 or 256, bf16 and fp32).
//
// What it computes, for each (b, query head h, query row i, key j) that the
// masks let through, with s_ij the forward's score (q_i . k_j * scale, then
// cap * tanh(s / cap)):
//   m_i = max_j s_ij, l_i = sum_j exp(s_ij - m_i)          (row statistics)
//   delta_i = sum_j P_ij (dO_i . v_j)  (= dO_i . O_i; fp32 reads it so from
//                                      the fp32 output, bf16 from fp32
//                                      products: the bf16 output's
//                                      rounding would land whole on rows
//                                      where dS cancels)
//   P_ij = exp(s_ij - m_i) / l_i
//   dV_j += round_v(exp(s_ij - m_i)) / l_i * dO_i   (p rounded to v's dtype,
//                                                    as the forward's p.v)
//   dS_ij = P_ij (dO_i . v_j - delta_i) (1 - (s_ij / cap)^2 with a cap)
//   dQ_i += scale dS_ij k_j,  dK_j += scale dS_ij q_i
// with dK and dV summed over the G = H / KV query heads that read KV head
// h / G.  Statistics, delta and every sum are fp32; the outputs are written
// once, in the inputs' dtype.  Up to the bf16 operands of the tensor-core
// path (below), this is the exact gradient of the forward's function.  The
// plain version's autograd in bf16 adds two roundings of its own (the
// gradient of p comes back through p's cast to bf16, so dO . v / l is
// rounded to bf16, and the rounding's residue lands on each row's argmax
// through amax's gradient); the kernel keeps neither, and rounds P / l
// once more than it does (a bf16 operand of dV).
//
// What bounds it on an H100 SXM: operations.  Five products of
// 2 * live_pairs * D FLOP each; gemma-2b's training shape (B 1, S 4096,
// 8 query heads on 1 KV head, D 256, causal) is 1.72e11 FLOP, 0.174 ms at
// the 989 TFLOP/s of the bf16 tensor cores.  The paths below compute eight
// products (fp32: the scores three times, dO.V^T twice) and nine (bf16:
// dO.V^T three times, for delta), and neither uses wgmma or TMA: a first
// design that is right, far from that bound.
//
// Design, four launches on one stream (five with masks by position):
//   pos_bounds (positions only)  least and greatest position of each
//       32-key chunk and 64-row q tile, so tiles that no pair can pass are
//       skipped as in the forward.
//   stats  one block per (b, h, 64 q rows): m, l by the forward's online
//       recurrence over the key tiles, and delta (bf16: by the same
//       recurrence over dO.V^T); fp32 to scratch.
//   dq  one block per (b, h, 64 q rows), looping over the live key tiles:
//       S and dO.V^T for the tile, dS into shared memory, dQ += dS K in
//       registers.  Written once.
//   dkdv  one block per (b, KV head, key tile, head split), looping over
//       its query heads and the live 64-row q tiles: S and dO.V^T again,
//       P and dS into shared memory, dV += P^T dO and dK += dS^T Q in
//       registers.  No atomics: with one split the block writes dK and dV
//       once; with several (MQA's few key tiles would leave most SMs idle:
//       gemma-2b has 128 key tiles of 32 for 132 SMs) each split writes
//       fp32 partials and flash_bwd_reduce sums them in split order.  So
//       two launches on the same inputs give the same bits.
// Two paths, one for each dtype (the wrapper hands both views that 16-byte
// copies can read):
//   bf16: the tensor cores, mma.sync m16n8k16 (bf16 operands, fp32 sums)
//     with operands from shared memory by ldmatrix (.trans for the
//     transposed ones: K in dQ, P^T, dS^T, dO and Q in dK and dV), rows
//     padded by 16 bytes so an ldmatrix hits eight bank groups.  8 warps
//     (stats: 4), 64 q rows a tile, 64 keys a tile in stats and dq,
//     8192 / D keys in dkdv (64 accumulators a thread for dK and dV at
//     every D).  P and dS are rounded to bf16 as operands.
//   fp32: plain fp32 FMAs, tiles as fp32 rows padded by 4 floats (16-byte
//     float4 reads, a quarter warp's rows on distinct banks), 32-key
//     tiles, 256 threads each owning a 2 x 4 patch of the score tile and a
//     4-row (dq) or 2-key (dk, dv) by D / 16-column patch of its outputs;
//     dS stays fp32.  At D = 256 a dkdv block takes 213.8 KB of shared
//     memory, one per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cstdint>

namespace {

constexpr float kNegInf = -1.0e38f;   // the forward's masked value
constexpr int kThreads = 256;
constexpr int kBQ = 64;               // q rows per tile
constexpr int kBK = 32;               // keys per tile
constexpr int kPad = 4;               // floats of padding per smem row
constexpr int kLP = kBK + kPad;       // row stride of P and dS [q][key]
constexpr int kLT = kBQ + kPad;       // row stride of dS^T [key][q]

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;                       // m, l, delta: 3 x [B * H * Sq]
  float* part;                        // fp32 dK, dV partials (nsplit > 1)
  // strides in elements of [B, S, heads, D] views; D is contiguous
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int64_t do_b, do_s, do_h, dq_b, dq_s, dq_h, dk_b, dk_s, dk_h;
  int64_t dv_b, dv_s, dv_h;
  int B, H, KV, Sq, Sk, nsplit;
  float scale, softcap;
  int causal, window;
  const int* pos;                     // positions [S], or null
  const int* kb;                      // (min, max) position per key tile
  const int* qb;                      // (min, max) position per q tile
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__global__ void pos_bounds_kernel(const int* __restrict__ pos, int S,
                                  int tile, int n, int* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  int lo = INT_MAX, hi = INT_MIN;
  const int end = min(S, (t + 1) * tile);
  for (int i = t * tile; i < end; ++i) {
    lo = min(lo, pos[i]);
    hi = max(hi, pos[i]);
  }
  out[2 * t] = lo;
  out[2 * t + 1] = hi;
}

// May q tile qt (64 rows) and the bk keys from k0 (a multiple of 32) hold
// a pair that passes the masks?  With positions, the key bounds are kept
// per 32-key chunk.
__device__ __forceinline__ bool tile_live(const BwdParams& p, int qt, int k0,
                                          int bk) {
  const int q0 = qt * kBQ;
  if (q0 >= p.Sq || k0 >= p.Sk) return false;
  bool live = true;
  if (p.pos) {
    long long klo = LLONG_MAX, khi = LLONG_MIN;
    const int end = min(k0 + bk, p.Sk);
    for (int c = k0 / kBK; c * kBK < end; ++c) {
      klo = min(klo, (long long)p.kb[2 * c]);
      khi = max(khi, (long long)p.kb[2 * c + 1]);
    }
    const long long qlo = p.qb[2 * qt], qhi = p.qb[2 * qt + 1];
    if (p.causal) live = klo <= qhi;
    if (p.window) live = live && khi > qlo - p.window;
  } else {
    const int qhi = min(q0 + kBQ, p.Sq) - 1;
    if (p.causal) live = k0 <= qhi;
    if (p.window) live = live && (long long)k0 + bk - 1 > (long long)q0 -
                                 p.window;
  }
  return live;
}

// May query i see key j (both in range)?
__device__ __forceinline__ bool pair_ok(const BwdParams& p, int i, int j) {
  if (i >= p.Sq || j >= p.Sk) return false;
  long long qp = i, kp = j;
  if (p.pos) {
    qp = p.pos[i];
    kp = p.pos[j];
  }
  bool ok = true;
  if (p.causal) ok = kp <= qp;
  if (p.window) ok = ok && kp > qp - p.window;
  return ok;
}

// The forward's score from a dot product: s = dot * scale, then the
// softcap; *t is tanh(s / cap) (0 without a cap).
__device__ __forceinline__ float score(const BwdParams& p, float dot,
                                      float* t) {
  float s = dot * p.scale;
  *t = 0.f;
  if (p.softcap != 0.f) {
    *t = tanhf(s / p.softcap);
    s = p.softcap * *t;
  }
  return s;
}

// rows [row0, row0 + rows) of one (b, head) of a [B, S, heads, D] view
// (base at (b, head, 0, 0)), widened to fp32, into dst with row stride
// D + kPad; rows past S read as zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          int64_t s_stride, int row0,
                                          int rows, int S) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = row0 + r;
    dst[r * (D + kPad) + d] = s < S ? base[(int64_t)s * s_stride + d]
                                    : 0.f;
  }
}

// acc[rr][j] = X[2 rp + rr] . Y[cl + 8 j] over D (rows of stride D + kPad):
// this thread's 2 x 4 patch of a 64 x 32 product.
template <int D>
__device__ __forceinline__ void tile_dots(const float* X, const float* Y,
                                          int rp, int cl,
                                          float (&acc)[2][4]) {
  constexpr int L = D + kPad;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[rr][j] = 0.f;
  const float* x0 = X + (2 * rp) * L;
  const float* y0 = Y + cl * L;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(x0 + d);
    const float4 a1 = *reinterpret_cast<const float4*>(x0 + L + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(y0 + 8 * j * L + d);
      acc[0][j] = fmaf(a0.x, b.x, acc[0][j]);
      acc[0][j] = fmaf(a0.y, b.y, acc[0][j]);
      acc[0][j] = fmaf(a0.z, b.z, acc[0][j]);
      acc[0][j] = fmaf(a0.w, b.w, acc[0][j]);
      acc[1][j] = fmaf(a1.x, b.x, acc[1][j]);
      acc[1][j] = fmaf(a1.y, b.y, acc[1][j]);
      acc[1][j] = fmaf(a1.z, b.z, acc[1][j]);
      acc[1][j] = fmaf(a1.w, b.w, acc[1][j]);
    }
  }
}

__device__ __forceinline__ float oct_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float oct_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// Row statistics: m, l and delta for 64 query rows of one (b, h).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_stats_kernel(const BwdParams p) {
  constexpr int L = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [kBQ][L]
  float* Ks = Qs + kBQ * L;                         // [kBK][L]

  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest causal first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, rp = tid / 8, cl = tid % 8;
  const float* qg = (const float*)p.q + b * p.q_b + h * p.q_h;
  const float* kg = (const float*)p.k + b * p.k_b + hk * p.k_h;
  load_rows<D>(Qs, qg, p.q_s, q0, kBQ, p.Sq);

  // delta: four threads a row, fp32
  {
    const int r = tid / 4, part = tid % 4, i = q0 + r;
    float acc = 0.f;
    if (i < p.Sq) {
      const float* og = (const float*)p.o + b * p.o_b + h * p.o_h +
                        i * p.o_s;
      const float* dg = (const float*)p.dout + b * p.do_b + h * p.do_h +
                        i * p.do_s;
      for (int d = part; d < D; d += 4) acc = fmaf(dg[d], og[d], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && i < p.Sq)
      p.stats[2 * (size_t)p.B * p.H * p.Sq + (size_t)bh * p.Sq + i] = acc;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int nk = (p.Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    if (!tile_live(p, qt, kt * kBK, kBK)) continue;
    __syncthreads();
    load_rows<D>(Ks, kg, p.k_s, kt * kBK, kBK, p.Sk);
    __syncthreads();
    float s[2][4];
    tile_dots<D>(Qs, Ks, rp, cl, s);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + 2 * rp + rr;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t;
        s[rr][j] = pair_ok(p, i, kt * kBK + cl + 8 * j)
                       ? score(p, s[rr][j], &t) : kNegInf;
        mx = fmaxf(mx, s[rr][j]);
      }
      const float mn = fmaxf(m[rr], oct_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[rr][j] - mn);
      l[rr] = l[rr] * expf(m[rr] - mn) + oct_sum(sum);
      m[rr] = mn;
    }
  }
  if (cl == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + 2 * rp + rr;
      if (i < p.Sq) {
        const size_t at = (size_t)bh * p.Sq + i;
        p.stats[at] = m[rr];
        p.stats[(size_t)p.B * p.H * p.Sq + at] = l[rr];
      }
    }
  }
}

// Row i's m, l and delta into shared memory for the 64 rows of q tile q0
// (rows past Sq get m 0, l 1, delta 0: their P and dS are set to 0).
__device__ __forceinline__ void load_stats(const BwdParams& p, int bh,
                                           int q0, float* st) {
  const size_t n = (size_t)p.B * p.H * p.Sq;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int i = q0 + r;
    const bool in = i < p.Sq;
    const size_t at = (size_t)bh * p.Sq + i;
    st[r] = in ? p.stats[at] : 0.f;
    st[kBQ + r] = in ? p.stats[n + at] : 1.f;
    st[2 * kBQ + r] = in ? p.stats[2 * n + at] : 0.f;
  }
}

// p rounded to T (v's dtype, as the forward's p.v rounds it) over l, for
// dV, and dS of one score-tile entry; both 0 where the pair is masked.
template <typename T>
__device__ __forceinline__ void entry(const BwdParams& p, bool ok,
                                      float dot, float dp, float m, float l,
                                      float delta, float* pn, float* ds) {
  if (!ok) {
    *pn = 0.f;
    *ds = 0.f;
    return;
  }
  float t;
  const float s = score(p, dot, &t);
  const float e = expf(s - m);
  const float inv = 1.f / l;
  *pn = to_f(from_f<T>(e)) * inv;
  float g = e * inv * (dp - delta);
  if (p.softcap != 0.f) g *= 1.f - t * t;
  *ds = g;
}

// ---------------------------------------------------------------------------
// dQ: one block per (b, h, 64 q rows), looping over the live key tiles.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int L = D + kPad;
  constexpr int NT = D / 64;          // float4 columns a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [kBQ][L]
  float* dOs = Qs + kBQ * L;                        // [kBQ][L]
  float* Ks = dOs + kBQ * L;                        // [kBK][L]
  float* Vs = Ks + kBK * L;                         // [kBK][L]
  float* dSt = Vs + kBK * L;                        // [kBK][kLT]
  float* st = dSt + kBK * kLT;                      // m, l, delta [3][kBQ]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, rp = tid / 8, cl = tid % 8;
  const int rg = tid / 16, dl = tid % 16;
  const float* kg = (const float*)p.k + b * p.k_b + hk * p.k_h;
  const float* vg = (const float*)p.v + b * p.v_b + hk * p.v_h;
  load_rows<D>(Qs, (const float*)p.q + b * p.q_b + h * p.q_h, p.q_s, q0,
               kBQ, p.Sq);
  load_rows<D>(dOs, (const float*)p.dout + b * p.do_b + h * p.do_h, p.do_s,
               q0, kBQ, p.Sq);
  load_stats(p, bh, q0, st);

  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  const int nk = (p.Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_live(p, qt, k0, kBK)) continue;
    __syncthreads();
    load_rows<D>(Ks, kg, p.k_s, k0, kBK, p.Sk);
    load_rows<D>(Vs, vg, p.v_s, k0, kBK, p.Sk);
    __syncthreads();
    float s[2][4], dp[2][4];
    tile_dots<D>(Qs, Ks, rp, cl, s);
    tile_dots<D>(dOs, Vs, rp, cl, dp);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * rp + rr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cl + 8 * j;
        float pn, ds;
        entry<float>(p, pair_ok(p, q0 + r, k0 + c), s[rr][j], dp[rr][j],
                     st[r], st[kBQ + r], st[2 * kBQ + r], &pn, &ds);
        dSt[c * kLT + r] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 g = *reinterpret_cast<const float4*>(dSt + c * kLT +
                                                        4 * rg);
      const float gr[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float4 kv = *reinterpret_cast<const float4*>(
            Ks + c * L + 4 * dl + 64 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][t][0] = fmaf(gr[i], kv.x, acc[i][t][0]);
          acc[i][t][1] = fmaf(gr[i], kv.y, acc[i][t][1]);
          acc[i][t][2] = fmaf(gr[i], kv.z, acc[i][t][2]);
          acc[i][t][3] = fmaf(gr[i], kv.w, acc[i][t][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= p.Sq) continue;
    float* out = (float*)p.dq + b * p.dq_b + h * p.dq_h + row * p.dq_s;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[4 * dl + 64 * t + e] = acc[i][t][e] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (b, KV head, 32-key tile, head split), looping over
// the split's query heads and the live q tiles.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int L = D + kPad;
  constexpr int NT = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [kBK][L]
  float* Vs = Ks + kBK * L;                         // [kBK][L]
  float* Qs = Vs + kBK * L;                         // [kBQ][L]
  float* dOs = Qs + kBQ * L;                        // [kBQ][L]
  float* Ps = dOs + kBQ * L;                        // [kBQ][kLP]
  float* dSs = Ps + kBQ * kLP;                      // [kBQ][kLP]
  float* st = dSs + kBQ * kLP;                      // m, l, delta [3][kBQ]

  const int kt = blockIdx.x;                        // heaviest causal first
  const int G = p.H / p.KV, per = G / p.nsplit;
  const int split = blockIdx.y % p.nsplit;
  const int bk = blockIdx.y / p.nsplit;
  const int b = bk / p.KV, hk = bk % p.KV;
  const int k0 = kt * kBK;
  const int tid = threadIdx.x, rp = tid / 8, cl = tid % 8;
  const int kg = tid / 16, dl = tid % 16;
  load_rows<D>(Ks, (const float*)p.k + b * p.k_b + hk * p.k_h, p.k_s, k0,
               kBK, p.Sk);
  load_rows<D>(Vs, (const float*)p.v + b * p.v_b + hk * p.v_h, p.v_s, k0,
               kBK, p.Sk);

  float dk[2][NT][4], dv[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][t][e] = dv[i][t][e] = 0.f;

  const int nq = (p.Sq + kBQ - 1) / kBQ;
  for (int hh = 0; hh < per; ++hh) {
    const int h = hk * G + split * per + hh;
    const int bh = b * p.H + h;
    const float* qg = (const float*)p.q + b * p.q_b + h * p.q_h;
    const float* dg = (const float*)p.dout + b * p.do_b + h * p.do_h;
    for (int qt = 0; qt < nq; ++qt) {
      if (!tile_live(p, qt, k0, kBK)) continue;
      const int q0 = qt * kBQ;
      __syncthreads();
      load_rows<D>(Qs, qg, p.q_s, q0, kBQ, p.Sq);
      load_rows<D>(dOs, dg, p.do_s, q0, kBQ, p.Sq);
      load_stats(p, bh, q0, st);
      __syncthreads();
      float s[2][4], dp[2][4];
      tile_dots<D>(Qs, Ks, rp, cl, s);
      tile_dots<D>(dOs, Vs, rp, cl, dp);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 2 * rp + rr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cl + 8 * j;
          entry<float>(p, pair_ok(p, q0 + r, k0 + c), s[rr][j],
                       dp[rr][j], st[r], st[kBQ + r], st[2 * kBQ + r],
                       Ps + r * kLP + c, dSs + r * kLP + c);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        const float2 pv = *reinterpret_cast<const float2*>(Ps + r * kLP +
                                                           2 * kg);
        const float2 gv = *reinterpret_cast<const float2*>(dSs + r * kLP +
                                                           2 * kg);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float4 ov = *reinterpret_cast<const float4*>(
              dOs + r * L + 4 * dl + 64 * t);
          const float4 qv = *reinterpret_cast<const float4*>(
              Qs + r * L + 4 * dl + 64 * t);
          dv[0][t][0] = fmaf(pv.x, ov.x, dv[0][t][0]);
          dv[0][t][1] = fmaf(pv.x, ov.y, dv[0][t][1]);
          dv[0][t][2] = fmaf(pv.x, ov.z, dv[0][t][2]);
          dv[0][t][3] = fmaf(pv.x, ov.w, dv[0][t][3]);
          dv[1][t][0] = fmaf(pv.y, ov.x, dv[1][t][0]);
          dv[1][t][1] = fmaf(pv.y, ov.y, dv[1][t][1]);
          dv[1][t][2] = fmaf(pv.y, ov.z, dv[1][t][2]);
          dv[1][t][3] = fmaf(pv.y, ov.w, dv[1][t][3]);
          dk[0][t][0] = fmaf(gv.x, qv.x, dk[0][t][0]);
          dk[0][t][1] = fmaf(gv.x, qv.y, dk[0][t][1]);
          dk[0][t][2] = fmaf(gv.x, qv.z, dk[0][t][2]);
          dk[0][t][3] = fmaf(gv.x, qv.w, dk[0][t][3]);
          dk[1][t][0] = fmaf(gv.y, qv.x, dk[1][t][0]);
          dk[1][t][1] = fmaf(gv.y, qv.y, dk[1][t][1]);
          dk[1][t][2] = fmaf(gv.y, qv.z, dk[1][t][2]);
          dk[1][t][3] = fmaf(gv.y, qv.w, dk[1][t][3]);
        }
      }
    }
  }

  const size_t n = (size_t)p.B * p.Sk * p.KV * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * kg + i;
    if (key >= p.Sk) continue;
    if (p.nsplit == 1) {
      float* ok = (float*)p.dk + b * p.dk_b + hk * p.dk_h + key * p.dk_s;
      float* ov = (float*)p.dv + b * p.dv_b + hk * p.dv_h + key * p.dv_s;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ok[4 * dl + 64 * t + e] = dk[i][t][e] * p.scale;
          ov[4 * dl + 64 * t + e] = dv[i][t][e];
        }
    } else {
      const size_t row = (((size_t)b * p.Sk + key) * p.KV + hk) * D;
      float* pk = p.part + (2 * (size_t)split) * n + row;
      float* pv = p.part + (2 * (size_t)split + 1) * n + row;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pk[4 * dl + 64 * t + e] = dk[i][t][e] * p.scale;
          pv[4 * dl + 64 * t + e] = dv[i][t][e];
        }
    }
  }
}

// dK, dV = the sum of the splits' partials, in split order, in T.
template <typename T, int D>
__global__ void flash_bwd_reduce_kernel(const BwdParams p) {
  const size_t n = (size_t)p.B * p.Sk * p.KV * D;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int d = (int)(idx % D);
    const size_t row = idx / D;
    const int hk = (int)(row % p.KV);
    const int key = (int)((row / p.KV) % p.Sk);
    const int b = (int)(row / ((size_t)p.KV * p.Sk));
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      sk += p.part[2 * (size_t)s * n + idx];
      sv += p.part[(2 * (size_t)s + 1) * n + idx];
    }
    ((T*)p.dk)[b * p.dk_b + key * p.dk_s + hk * p.dk_h + d] = from_f<T>(sk);
    ((T*)p.dv)[b * p.dv_b + key * p.dv_s + hk * p.dv_h + d] = from_f<T>(sv);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, bf16 operands from shared
// memory by ldmatrix, fp32 accumulators in registers.  The same three
// kernels in the same order; S and dO.V^T of a tile, P and dS go through
// shared memory as bf16 (dS rounded to bf16 for the dq and dk products,
// where the fp32 kernels keep it in fp32).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kRowPad = 8;            // bf16 of padding per shared row: the
                                      // 8 rows of an ldmatrix hit 8 bank
                                      // groups
constexpr int kMmaBK = 64;            // keys per tile in stats and dq
constexpr int kStatsThreads = 128;    // 4 warps, 16 q rows each

// Keys per block of the dk/dv kernel: 64 accumulators a thread for dK and
// dV together at every D (32, 64, 128 keys).
template <int D>
__host__ __device__ constexpr int mma_key_tile() { return 8192 / D; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// d += a b for one 16 x 8 x 16 tile (a: 4 registers of bf16 pairs, rows
// g and g + 8, k pairs 2t and 2t + 8; b: k pairs 2t and 2t + 8 of column g;
// d: rows g and g + 8, columns 2t, 2t + 1; g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8; r[j] is this lane's pair of matrix j (trans:
// of its transpose).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row))
      : "memory");
}

// The four ldmatrix layouts, as the row this lane addresses at (r0, c0):
// A (16 x 16, m x k) from [m][k] storage; A from [k][m] storage (trans);
// B (two n-tiles of 8, k 16) from [n][k] storage; B from [k][n] (trans).
__device__ __forceinline__ const bf16* a_rows(const bf16* base, int ld,
                                              int m0, int k0, int lane) {
  return base + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 +
         (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* at_rows(const bf16* base, int ld,
                                               int m0, int k0, int lane) {
  return base + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* b_rows(const bf16* base, int ld,
                                              int n0, int k0, int lane) {
  return base + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* bt_rows(const bf16* base, int ld,
                                               int n0, int k0, int lane) {
  return base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + rows) of one (b, head) into bf16 shared rows of
// stride D + kRowPad, 16 bytes a copy (the wrapper checks alignment); rows
// past S read as zeros.
template <int D>
__device__ __forceinline__ void load_rows16(bf16* dst, const bf16* base,
                                            int64_t s_stride, int row0,
                                            int rows, int S, int threads) {
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < rows * V; idx += threads) {
    const int r = idx / V, c = idx % V, s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(base + (int64_t)s * s_stride +
                                            8 * c);
    *reinterpret_cast<uint4*>(dst + r * (D + kRowPad) + 8 * c) = val;
  }
}

// acc[j] += X[m0 .. m0 + 16) . Y[n0 + 8 j ..)^T over D, for NT n-tiles
// (NT even): the score-like products Q K^T and dO V^T, both operands with
// D contiguous.
template <int D, int NT>
__device__ __forceinline__ void rows_dot_rows(const bf16* X, const bf16* Y,
                                              int m0, int n0, int lane,
                                              float (&acc)[NT][4]) {
  constexpr int L = D + kRowPad;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; k += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_rows(X, L, m0, k, lane));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_rows(Y, L, n0 + 8 * j, k, lane));
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kStatsThreads, 1)
flash_bwd_stats_mma(const BwdParams p) {
  constexpr int L = D + kRowPad;
  constexpr int NT = kMmaBK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [kBQ][L]
  bf16* dOs = Qs + kBQ * L;                         // [kBQ][L]
  bf16* Ks = dOs + kBQ * L;                         // [kMmaBK][L]
  bf16* Vs = Ks + kMmaBK * L;                       // [kMmaBK][L]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kg = (const bf16*)p.k + b * p.k_b + hk * p.k_h;
  const bf16* vg = (const bf16*)p.v + b * p.v_b + hk * p.v_h;
  load_rows16<D>(Qs, (const bf16*)p.q + b * p.q_b + h * p.q_h, p.q_s, q0,
                 kBQ, p.Sq, kStatsThreads);
  load_rows16<D>(dOs, (const bf16*)p.dout + b * p.do_b + h * p.do_h, p.do_s,
                 q0, kBQ, p.Sq, kStatsThreads);

  // m and l by the forward's online recurrence; a = sum_j exp(s - m) dp
  // by the same one, so delta = a / l = sum_j P_ij (dO_i . v_j) from the
  // fp32 products the dq and dk kernels use (rowsum(dO o O) would carry
  // the bf16 output's rounding, whole where dS cancels)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < p.Sk; k0 += kMmaBK) {
    if (!tile_live(p, qt, k0, kMmaBK)) continue;
    __syncthreads();
    load_rows16<D>(Ks, kg, p.k_s, k0, kMmaBK, p.Sk, kStatsThreads);
    load_rows16<D>(Vs, vg, p.v_s, k0, kMmaBK, p.Sk, kStatsThreads);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    rows_dot_rows<D, NT>(Qs, Ks, 16 * warp, 0, lane, s);
    rows_dot_rows<D, NT>(dOs, Vs, 16 * warp, 0, lane, dp);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = q0 + 16 * warp + g + 8 * half;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float tt;
          float& v = s[j][2 * half + e];
          v = pair_ok(p, i, k0 + 8 * j + 2 * t + e) ? score(p, v, &tt)
                                                     : kNegInf;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[half], mx);
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float w = expf(s[j][2 * half + e] - mn);
          sum += w;
          dsum = fmaf(w, dp[j][2 * half + e], dsum);
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      const float r = expf(m[half] - mn);
      l[half] = l[half] * r + sum;
      a[half] = a[half] * r + dsum;
      m[half] = mn;
    }
  }
  if (t == 0) {
    const size_t n = (size_t)p.B * p.H * p.Sq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = q0 + 16 * warp + g + 8 * half;
      if (i < p.Sq) {
        const size_t at = (size_t)bh * p.Sq + i;
        p.stats[at] = m[half];
        p.stats[n + at] = l[half];
        p.stats[2 * n + at] = l[half] > 0.f ? a[half] / l[half] : 0.f;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_mma(const BwdParams p) {
  constexpr int L = D + kRowPad, LS = kMmaBK + kRowPad;
  constexpr int SNT = kMmaBK / 16;    // score n-tiles a warp computes: 4
  constexpr int QNT = D / 16;         // dq n-tiles a warp owns: D / 2 cols
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [kBQ][L]
  bf16* dOs = Qs + kBQ * L;                         // [kBQ][L]
  bf16* Ks = dOs + kBQ * L;                         // [kMmaBK][L]
  bf16* Vs = Ks + kMmaBK * L;                       // [kMmaBK][L]
  bf16* dSs = Vs + kMmaBK * L;                      // [kBQ][LS]
  float* st = reinterpret_cast<float*>(dSs + kBQ * LS);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;   // q rows 16 wm; half wn
  const bf16* kg = (const bf16*)p.k + b * p.k_b + hk * p.k_h;
  const bf16* vg = (const bf16*)p.v + b * p.v_b + hk * p.v_h;
  load_rows16<D>(Qs, (const bf16*)p.q + b * p.q_b + h * p.q_h, p.q_s, q0,
                 kBQ, p.Sq, kThreads);
  load_rows16<D>(dOs, (const bf16*)p.dout + b * p.do_b + h * p.do_h, p.do_s,
                 q0, kBQ, p.Sq, kThreads);
  load_stats(p, bh, q0, st);

  float acc[QNT][4];
#pragma unroll
  for (int j = 0; j < QNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += kMmaBK) {
    if (!tile_live(p, qt, k0, kMmaBK)) continue;
    __syncthreads();
    load_rows16<D>(Ks, kg, p.k_s, k0, kMmaBK, p.Sk, kThreads);
    load_rows16<D>(Vs, vg, p.v_s, k0, kMmaBK, p.Sk, kThreads);
    __syncthreads();
    float s[SNT][4], dp[SNT][4];
    rows_dot_rows<D, SNT>(Qs, Ks, 16 * wm, 8 * SNT * wn, lane, s);
    rows_dot_rows<D, SNT>(dOs, Vs, 16 * wm, 8 * SNT * wn, lane, dp);
#pragma unroll
    for (int j = 0; j < SNT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * wm + g + 8 * half;
        const int c = 8 * (SNT * wn + j) + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pn;
          entry<bf16>(p, pair_ok(p, q0 + r, k0 + c + e), s[j][2 * half + e],
                      dp[j][2 * half + e], st[r], st[kBQ + r],
                      st[2 * kBQ + r], &pn, &ds[e]);
        }
        *reinterpret_cast<uint32_t*>(dSs + r * LS + c) = pack(ds[0], ds[1]);
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_rows(dSs, LS, 16 * wm, kk, lane));
#pragma unroll
      for (int j = 0; j < QNT; j += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, bt_rows(Ks, L, (D / 2) * wn + 8 * j, kk, lane));
        mma_bf16(acc[j], a, bb[0], bb[1]);
        mma_bf16(acc[j + 1], a, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * wm + g + 8 * half;
    if (row >= p.Sq) continue;
    bf16* out = (bf16*)p.dq + b * p.dq_b + h * p.dq_h + row * p.dq_s;
#pragma unroll
    for (int j = 0; j < QNT; ++j) {
      const int c = (D / 2) * wn + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(out + c) =
          pack(acc[j][2 * half] * p.scale, acc[j][2 * half + 1] * p.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_mma(const BwdParams p) {
  constexpr int BC = mma_key_tile<D>();
  constexpr int L = D + kRowPad, LP = BC + kRowPad;
  constexpr int MT = BC / 16;         // key m-tiles of dK, dV: 2, 4, 8
  constexpr int DC = 64;              // columns a warp owns of each
  constexpr int SNT = BC / 16;        // score n-tiles a warp computes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);     // [BC][L]
  bf16* Vs = Ks + BC * L;                           // [BC][L]
  bf16* Qs = Vs + BC * L;                           // [kBQ][L]
  bf16* dOs = Qs + kBQ * L;                         // [kBQ][L]
  bf16* Ps = dOs + kBQ * L;                         // [kBQ][LP]
  bf16* dSs = Ps + kBQ * LP;                        // [kBQ][LP]
  float* st = reinterpret_cast<float*>(dSs + kBQ * LP);

  const int kt = blockIdx.x;
  const int G = p.H / p.KV, per = G / p.nsplit;
  const int split = blockIdx.y % p.nsplit;
  const int bk = blockIdx.y / p.nsplit;
  const int b = bk / p.KV, hk = bk % p.KV;
  const int k0 = kt * BC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int am = warp % MT, ac = warp / MT;  // keys 16 am, columns DC ac
  const int wm = warp & 3, wn = warp >> 2;   // score rows 16 wm; half wn
  load_rows16<D>(Ks, (const bf16*)p.k + b * p.k_b + hk * p.k_h, p.k_s, k0,
                 BC, p.Sk, kThreads);
  load_rows16<D>(Vs, (const bf16*)p.v + b * p.v_b + hk * p.v_h, p.v_s, k0,
                 BC, p.Sk, kThreads);

  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int nq = (p.Sq + kBQ - 1) / kBQ;
  for (int hh = 0; hh < per; ++hh) {
    const int h = hk * G + split * per + hh;
    const int bh = b * p.H + h;
    const bf16* qg = (const bf16*)p.q + b * p.q_b + h * p.q_h;
    const bf16* dg = (const bf16*)p.dout + b * p.do_b + h * p.do_h;
    for (int qt = 0; qt < nq; ++qt) {
      if (!tile_live(p, qt, k0, BC)) continue;
      const int q0 = qt * kBQ;
      __syncthreads();
      load_rows16<D>(Qs, qg, p.q_s, q0, kBQ, p.Sq, kThreads);
      load_rows16<D>(dOs, dg, p.do_s, q0, kBQ, p.Sq, kThreads);
      load_stats(p, bh, q0, st);
      __syncthreads();
      float s[SNT][4], dp[SNT][4];
      rows_dot_rows<D, SNT>(Qs, Ks, 16 * wm, 8 * SNT * wn, lane, s);
      rows_dot_rows<D, SNT>(dOs, Vs, 16 * wm, 8 * SNT * wn, lane, dp);
#pragma unroll
      for (int j = 0; j < SNT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * wm + g + 8 * half;
          const int c = 8 * (SNT * wn + j) + 2 * t;
          float pn[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            entry<bf16>(p, pair_ok(p, q0 + r, k0 + c + e),
                        s[j][2 * half + e], dp[j][2 * half + e], st[r],
                        st[kBQ + r], st[2 * kBQ + r], &pn[e], &ds[e]);
          *reinterpret_cast<uint32_t*>(Ps + r * LP + c) = pack(pn[0], pn[1]);
          *reinterpret_cast<uint32_t*>(dSs + r * LP + c) =
              pack(ds[0], ds[1]);
        }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBQ; kk += 16) {
        uint32_t ap[4], as[4];
        ldsm_x4_t(ap, at_rows(Ps, LP, 16 * am, kk, lane));
        ldsm_x4_t(as, at_rows(dSs, LP, 16 * am, kk, lane));
#pragma unroll
        for (int j = 0; j < DC / 8; j += 2) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, bt_rows(dOs, L, DC * ac + 8 * j, kk, lane));
          mma_bf16(dv[j], ap, bo[0], bo[1]);
          mma_bf16(dv[j + 1], ap, bo[2], bo[3]);
          ldsm_x4_t(bq, bt_rows(Qs, L, DC * ac + 8 * j, kk, lane));
          mma_bf16(dk[j], as, bq[0], bq[1]);
          mma_bf16(dk[j + 1], as, bq[2], bq[3]);
        }
      }
    }
  }

  const size_t n = (size_t)p.B * p.Sk * p.KV * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + 16 * am + g + 8 * half;
    if (key >= p.Sk) continue;
    const size_t row = (((size_t)b * p.Sk + key) * p.KV + hk) * D;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int c = DC * ac + 8 * j + 2 * t;
      const float k0v = dk[j][2 * half] * p.scale;
      const float k1v = dk[j][2 * half + 1] * p.scale;
      const float v0 = dv[j][2 * half], v1 = dv[j][2 * half + 1];
      if (p.nsplit == 1) {
        *reinterpret_cast<uint32_t*>((bf16*)p.dk + b * p.dk_b +
                                     hk * p.dk_h + key * p.dk_s + c) =
            pack(k0v, k1v);
        *reinterpret_cast<uint32_t*>((bf16*)p.dv + b * p.dv_b +
                                     hk * p.dv_h + key * p.dv_s + c) =
            pack(v0, v1);
      } else {
        float* pk = p.part + (2 * (size_t)split) * n + row + c;
        float* pv = p.part + (2 * (size_t)split + 1) * n + row + c;
        pk[0] = k0v;
        pk[1] = k1v;
        pv[0] = v0;
        pv[1] = v1;
      }
    }
  }
}

template <int D>
constexpr size_t stats_mma_smem() {
  return sizeof(bf16) * 2 * (kBQ + kMmaBK) * (D + kRowPad);
}
template <int D>
constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (2 * (kBQ + kMmaBK) * (D + kRowPad) +
                         kBQ * (kMmaBK + kRowPad)) + sizeof(float) * 3 * kBQ;
}
template <int D>
constexpr size_t dkdv_mma_smem() {
  return sizeof(bf16) * (2 * (mma_key_tile<D>() + kBQ) * (D + kRowPad) +
                         2 * kBQ * (mma_key_tile<D>() + kRowPad)) +
         sizeof(float) * 3 * kBQ;
}

template <typename Kernel>
cudaError_t launch_n(Kernel kernel, dim3 grid, int threads, size_t smem,
                     const BwdParams& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch_mma(const BwdParams& p, cudaStream_t s) {
  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int nk = (p.Sk + mma_key_tile<D>() - 1) / mma_key_tile<D>();
  cudaError_t err = launch_n(flash_bwd_stats_mma<D>, dim3(nq, p.B * p.H),
                             kStatsThreads, stats_mma_smem<D>(), p, s);
  if (err == cudaSuccess)
    err = launch_n(flash_bwd_dq_mma<D>, dim3(nq, p.B * p.H), kThreads,
                   dq_mma_smem<D>(), p, s);
  if (err == cudaSuccess)
    err = launch_n(flash_bwd_dkdv_mma<D>, dim3(nk, p.B * p.KV * p.nsplit),
                   kThreads, dkdv_mma_smem<D>(), p, s);
  if (err == cudaSuccess && p.nsplit > 1) {
    flash_bwd_reduce_kernel<bf16, D><<<264, kThreads, 0, s>>>(p);
    err = cudaGetLastError();
  }
  return (int)err;
}

int launch_mma_d(const BwdParams& p, int D, cudaStream_t s) {
  switch (D) {
    case 64: return launch_mma<64>(p, s);
    case 128: return launch_mma<128>(p, s);
    case 256: return launch_mma<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
constexpr size_t stats_smem() {
  return sizeof(float) * (kBQ + kBK) * (D + kPad);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (kBQ + kBK) * (D + kPad) + kBK * kLT +
                          3 * kBQ);
}
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * (kBQ + kBK) * (D + kPad) + 2 * kBQ * kLP +
                          3 * kBQ);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem,
                   const BwdParams& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch_fma(const BwdParams& p, cudaStream_t s) {
  const int nq = (p.Sq + kBQ - 1) / kBQ, nk = (p.Sk + kBK - 1) / kBK;
  cudaError_t err = launch(flash_bwd_stats_kernel<D>, dim3(nq, p.B * p.H),
                           stats_smem<D>(), p, s);
  if (err == cudaSuccess)
    err = launch(flash_bwd_dq_kernel<D>, dim3(nq, p.B * p.H), dq_smem<D>(),
                 p, s);
  if (err == cudaSuccess)
    err = launch(flash_bwd_dkdv_kernel<D>, dim3(nk, p.B * p.KV * p.nsplit),
                 dkdv_smem<D>(), p, s);
  if (err == cudaSuccess && p.nsplit > 1) {
    flash_bwd_reduce_kernel<float, D><<<264, kThreads, 0, s>>>(p);
    err = cudaGetLastError();
  }
  return (int)err;
}

int launch_fma_d(const BwdParams& p, int D, cudaStream_t s) {
  switch (D) {
    case 64: return launch_fma<64>(p, s);
    case 128: return launch_fma<128>(p, s);
    case 256: return launch_fma<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, o, dout, dq are [B, Sq, H, D]
// views and k, v, dk, dv [B, Sk, KV, D] views given by their strides
// (strides: 24 int64, three (b, s, head) triples in the order q, k, v, o,
// dout, dq, dk, dv; D contiguous).  stats is fp32 scratch of 3 * B * H * Sq
// elements; partials fp32 scratch of 2 * nsplit * B * Sk * KV * D elements
// when nsplit > 1 (else unused), with nsplit dividing H / KV.  positions
// (int32 [S], Sq == Sk) masks by position when not null, with bounds int32
// scratch of 2 * (ceil(Sk / 32) + ceil(Sq / 64)) elements.  Launches on
// `stream` and returns the CUDA error (0 when every launch was accepted).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, int B, int H, int KV,
    int Sq, int Sk, int D, const int64_t* strides, float scale,
    float softcap, int causal, int window, int dtype_bf16,
    const void* positions, void* bounds, void* stats, void* partials,
    int nsplit, void* stream) {
  if (KV <= 0 || H % KV || nsplit < 1 || (H / KV) % nsplit ||
      (positions && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.stats = (float*)stats;
  p.part = (float*)partials;
  const int64_t* st = strides;
  p.q_b = st[0]; p.q_s = st[1]; p.q_h = st[2];
  p.k_b = st[3]; p.k_s = st[4]; p.k_h = st[5];
  p.v_b = st[6]; p.v_s = st[7]; p.v_h = st[8];
  p.o_b = st[9]; p.o_s = st[10]; p.o_h = st[11];
  p.do_b = st[12]; p.do_s = st[13]; p.do_h = st[14];
  p.dq_b = st[15]; p.dq_s = st[16]; p.dq_h = st[17];
  p.dk_b = st[18]; p.dk_s = st[19]; p.dk_h = st[20];
  p.dv_b = st[21]; p.dv_s = st[22]; p.dv_h = st[23];
  p.B = B; p.H = H; p.KV = KV; p.Sq = Sq; p.Sk = Sk; p.nsplit = nsplit;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window;
  p.pos = (const int*)positions;
  p.kb = p.qb = nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (positions) {
    const int nkt = (Sk + kBK - 1) / kBK, nqt = (Sq + kBQ - 1) / kBQ;
    int* kb = (int*)bounds;
    p.kb = kb;
    p.qb = kb + 2 * nkt;
    pos_bounds_kernel<<<(nkt + 127) / 128, 128, 0, s>>>(p.pos, Sk, kBK, nkt,
                                                        kb);
    pos_bounds_kernel<<<(nqt + 127) / 128, 128, 0, s>>>(p.pos, Sq, kBQ, nqt,
                                                        kb + 2 * nkt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return dtype_bf16 ? launch_mma_d(p, D, s) : launch_fma_d(p, D, s);
}
