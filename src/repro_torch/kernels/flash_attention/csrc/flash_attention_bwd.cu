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
// H % KV == 0, head_dim 16, 32, 64, 80, 128 or 256, bf16 and fp32).
//
// What it computes, for each (b, query head h, query row i, key j) that the
// masks let through, with s_ij the forward's score (q_i . k_j * scale, then
// cap * tanh(s / cap)):
//   lse_i = log sum_j exp(s_ij)                            (row statistics)
//   delta_i = sum_j P_ij (dO_i . v_j)  (= dO_i . O_i)
//   P_ij = exp(s_ij - lse_i)
//   dV_j += P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - delta_i) (1 - (s_ij / cap)^2 with a cap)
//   dQ_i += scale dS_ij k_j,  dK_j += scale dS_ij q_i
// with dK and dV summed over the G = H / KV query heads that read KV head
// h / G.  Statistics, delta and every sum are fp32; the outputs are written
// once, in the inputs' dtype.
//
// What bounds it on an H100 SXM: operations.  Five products of
// 2 * live_pairs * D FLOP each; gemma-2b's training shape (B 1, S 4096,
// 8 query heads on 1 KV head, D 256, causal) is 1.72e11 FLOP, 0.174 ms at
// the 989 TFLOP/s of the bf16 tensor cores.
//
// bf16 (wgmma fed by TMA, warp-specialised; three launches, a fourth for
// head splits, two more with masks by position):
//   The forward recorded for autograd keeps lse and its fp32 output O
//   (flash_attention_stats_launch), so nothing here recomputes the row
//   statistics.  delta comes from that fp32 output: taken from the bf16
//   output, O's rounding lands whole on rows where dS cancels (dq's worst
//   row read 0.28 from the plain version at global_capped on an NVIDIA
//   H100 80GB HBM3 at 700.00 W; a float64 emulation gives 0.034 with the
//   fp32 output, 0.110 with the bf16 one: tests/test_torch_train.py).
//   flash_bwd_delta  delta = rowsum(dO o O), one warp a row (memory-bound).
//   flash_bwd_dq_wgmma  one block per (b, head, 128 q rows), the forward's
//     layout: a producer warp keeps K and V tiles (48 keys at D = 256, else
//     64) in flight through a ring of mbarrier stages; two consumer
//     warpgroups own 64 q rows each: S and dP by wgmma (Q, dO and K, V
//     K-major from shared memory), dS in registers, dQ += dS K with dS as
//     wgmma's register operand and K MN-major; three products.
//   flash_bwd_dkdv_wgmma  one block per (b, KV head, 64 keys, head split):
//     K and V resident, Q and dO tiles through the ring with each row's
//     lse and delta; the consumer warpgroups split by role, S^T = K Q^T
//     and dV += P^T dO on one, dP^T = V dO^T and dK += dS^T Q on the
//     other, P f (the softcap factor) handed over through shared memory;
//     four products.  dK, dV accumulators stay in registers (128 a thread
//     at D = 256).  One split writes dK and dV once; several (MQA's few
//     key tiles would leave most SMs idle: gemma-2b has 64 key tiles for
//     132 SMs) write fp32 partials that
//   flash_bwd_reduce_kernel  sums in split order.
//   D = 80 (hubert-xlarge's heads) keeps the D = 128 shared-memory
//   layout, padded, as the forward does: the tensor maps keep the real 80
//   columns, so TMA zero-fills columns 80..127 of each tile's second box.
//   The products run at the real width (S and dP over five k16 steps; dQ,
//   dK and dV as m64n80k16 across a 64-column swizzle atom and 16 columns
//   of the next), and every access by address (delta, the epilogues, the
//   partials) stops at column 80.  D = 16 and 32 keep the D = 64 layout
//   the same way (per-head tensor maps of D columns, zeros past D): S and
//   dP take one or two k16 steps, dQ, dK and dV run as m64n16k16 or
//   m64n32k16, and every store stops at D.
//   Seven products in all: dq recomputes S and dP rather than take dQ by
//   atomics, so two launches on the same inputs give the same bits.
//   Blocks run every head and split of the heaviest causal tile first
//   (one head's tiles after another's left heavy blocks for the end:
//   gemma-2b's backward 25% slower).  Each element loop branches on the
//   softcap outside the unrolled loop (a branch inside it made dkdv 23-48%
//   slower).  On an H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section
//   6, row 3b) gemma-2b's backward took 0.522 ms, a third of the
//   five-product bound's rate, where the mma.sync design it replaces took
//   4.05 ms.
//
// fp32 (FMAs; three launches, a fourth for head splits, two more with
// positions), as before:
//   pos_bounds  least and greatest position of each 32-key chunk and 64-row
//     q tile, so tiles that no pair can pass are skipped.
//   stats  one block per (b, h, 64 q rows): m, l by the forward's online
//     recurrence and delta = dO . O from the fp32 output; fp32 to scratch.
//   dq  one block per (b, h, 64 q rows), looping over the live 32-key
//     tiles: S and dO.V^T, dS in shared memory, dQ += dS K in registers.
//   dkdv  one block per (b, KV head, 32-key tile, head split), looping over
//     its query heads and live q tiles; fp32 partials for several splits.
//   Tiles as fp32 rows padded by 4 floats (16-byte float4 reads), 256
//   threads each owning a 2 x 4 patch of the score tile; at D = 256 a dkdv
//   block takes 213.8 KB of shared memory, one per SM.  The dQ, dK and dV
//   sums give each of 16 threads four columns of every 64: at D = 80 the
//   second 64 holds 16 real columns, which threads 0..3 of the 16 own
//   (the others skip them; col_live), as at D = 16 (threads 0..3) and
//   D = 32 (threads 0..7) in the first 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cstdint>

#include "hopper.cuh"                 // TMA, mbarriers, wgmma

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
  // bf16 (wgmma) only
  const int* kbd;                     // the same per key tile of dq
  const float* o32;                   // the forward's fp32 output
  const float* lse;                   // its rows' logsumexp [B, H, Sq]
  float* delta;                       // scratch [B, H, Sq]
  float score_mul;                    // (softcap ? cap : scale) * log2(e)
  float tanh_mul;                     // 2 log2(e) scale / cap
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

// Does the float4 column group t (of 64 columns) of thread dl (of 16)
// start inside a row of D columns?  Always where D is a multiple of 64.
template <int D>
__device__ __forceinline__ bool col_live(int t, int dl) {
  return D % 64 == 0 || 64 * t + 4 * dl < D;
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
  constexpr int NT = (D + 63) / 64;   // float4 columns a thread owns
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
        if (!col_live<D>(t, dl)) continue;
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
      if (col_live<D>(t, dl))
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
  constexpr int NT = (D + 63) / 64;
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
          if (!col_live<D>(t, dl)) continue;
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
        if (col_live<D>(t, dl))
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
        if (col_live<D>(t, dl))
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pk[4 * dl + 64 * t + e] = dk[i][t][e] * p.scale;
            pv[4 * dl + 64 * t + e] = dv[i][t][e];
          }
    }
  }
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// dK, dV = the sum of the splits' partials, in split order, in T (dK and
// dV are the wrapper's own contiguous tensors): four columns a thread.
template <typename T, int D>
__global__ void flash_bwd_reduce_kernel(const BwdParams p) {
  const size_t n = (size_t)p.B * p.Sk * p.KV * D;
  const float4* part = reinterpret_cast<const float4*>(p.part);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int d = (int)(4 * i % D);
    const size_t row = 4 * i / D;
    const int hk = (int)(row % p.KV);
    const int key = (int)((row / p.KV) % p.Sk);
    const int b = (int)(row / ((size_t)p.KV * p.Sk));
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int s = 0; s < p.nsplit; ++s) {
      add4(sk, part[2 * (size_t)s * (n / 4) + i]);
      add4(sv, part[(2 * (size_t)s + 1) * (n / 4) + i]);
    }
    store4((T*)p.dk + b * p.dk_b + key * p.dk_s + hk * p.dk_h + d, sk);
    store4((T*)p.dv + b * p.dv_b + key * p.dv_s + hk * p.dv_h + d, sv);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, warp-specialised.  After the delta pre-pass,
// dq (one block per 128 q rows of one head) and dkdv (one block per 64 keys
// of one KV head and head split); a reduce sums MQA's head splits.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kT = 64;                // rows of every tile, q and keys
constexpr int kWThreads = 384;        // producer + two consumer warpgroups
constexpr uint32_t kBoxBytes = kT * 128;   // one TMA box: 64 rows x 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// The width a head of D columns takes in shared memory: whole 64-column
// boxes (80 -> 128; the rest are D itself).
template <int D>
__host__ __device__ constexpr int padded() {
  return (D + 63) / 64 * 64;
}

// The dkdv ring's stages: what fits in 227 KB beside the resident K and V
// (D = 256: 64 KB resident, 2 x 64 KB of Q and dO, 32 KB of P f).
template <int D>
__host__ __device__ constexpr int dkdv_stages() {
  return padded<D>() == 256 ? 2 : padded<D>() == 128 ? 4 : 8;
}

// dkdv's shared memory: resident K and V, the ring (Q and dO tiles), its
// row statistics (lse, delta: 64 + 64 floats a stage), the two buffers that
// carry P f from warpgroup 0 to warpgroup 1 (16 KB each), the mbarriers,
// and slack to align the tiles to 1024 bytes (the 128-byte swizzle's
// period).
template <int D>
constexpr size_t dkdv_smem_bytes() {
  return 1024 + 2 * 128 * (size_t)padded<D>() * (1 + dkdv_stages<D>()) +
         512 * dkdv_stages<D>() + 2 * 16384 +
         8 * (1 + 2 * dkdv_stages<D>() + 4);
}

// dq's key tiles and stages: 128 resident q rows of Q and dO (128 KB at
// D = 256) leave room for two stages of 48-key K and V tiles (96 KB).
template <int D>
__host__ __device__ constexpr int dq_key_tile() {
  return padded<D>() == 256 ? 48 : 64;
}
template <int D>
__host__ __device__ constexpr int dq_stages() {
  return padded<D>() == 256 ? 2 : padded<D>() == 128 ? 4 : 8;
}
template <int D>
constexpr size_t dq_smem_bytes() {
  return 1024 + 2 * (size_t)padded<D>() * (2 * 128 + 2 * dq_stages<D>() *
                                           dq_key_tile<D>()) +
         8 * (1 + 2 * dq_stages<D>());
}

// May the 64 q rows of chunk qt and the bk keys of tile kt hold a pair
// that passes the masks?  With positions, p.qb holds each 64-row q chunk's
// least and greatest position and kb each bk-key tile's.
__device__ __forceinline__ bool w_live(const BwdParams& p, int qt, int kt,
                                       int bk, const int* kb) {
  const int q0 = qt * kT, k0 = kt * bk;
  if (q0 >= p.Sq || k0 >= p.Sk) return false;
  bool live = true;
  if (p.pos) {
    const long long klo = kb[2 * kt], khi = kb[2 * kt + 1];
    const long long qlo = p.qb[2 * qt], qhi = p.qb[2 * qt + 1];
    if (p.causal) live = klo <= qhi;
    if (p.window) live = live && khi > qlo - p.window;
  } else {
    const long long qhi = min(q0 + kT, p.Sq) - 1;
    const long long khi = min(k0 + bk, p.Sk) - 1;
    if (p.causal) live = k0 <= qhi;
    if (p.window) live = live && khi > q0 - p.window;
  }
  return live;
}

// Does that pair of tiles need element masks: a ragged end, or some pair
// that fails the causal or window mask?
__device__ __forceinline__ bool w_edge(const BwdParams& p, int qt, int kt,
                                       int bk, const int* kb) {
  const long long q0 = qt * kT, k0 = kt * bk;
  if (q0 + kT > p.Sq || k0 + bk > p.Sk) return true;
  long long qlo = q0, qhi = q0 + kT - 1, klo = k0, khi = k0 + bk - 1;
  if (p.pos) {
    klo = kb[2 * kt]; khi = kb[2 * kt + 1];
    qlo = p.qb[2 * qt]; qhi = p.qb[2 * qt + 1];
  }
  bool edge = false;
  if (p.causal) edge = khi > qlo;
  if (p.window) edge = edge || klo <= qhi - p.window;
  return edge;
}

// May query qi see key kj (both in range)?
__device__ __forceinline__ bool w_pair_ok(const BwdParams& p, int qi,
                                          int kj) {
  if (qi >= p.Sq || kj >= p.Sk) return false;
  long long qp = qi, kp = kj;
  if (p.pos) {
    qp = p.pos[qi];
    kp = p.pos[kj];
  }
  bool ok = true;
  if (p.causal) ok = kp <= qp;
  if (p.window) ok = ok && kp > qp - p.window;
  return ok;
}

// The forward's capped score in log2 units from a dot product, and dS's
// softcap factor 1 - tanh^2 = 4 r (1 - r), by the forward's operations
// (softcap_log2 in flash_attention.cu), so that P = 2^(s - lse) meets the
// forward's statistics.  Without a cap the score is dot * score_mul and
// the factor 1; callers branch on the cap outside their unrolled loops.
__device__ __forceinline__ float capped_log2(const BwdParams& p, float dot,
                                             float* f) {
  const float y = fminf(1.f + ex2(dot * p.tanh_mul), 1e30f);
  float r = __int_as_float(0x7EF311C3 - __float_as_int(y));
#pragma unroll
  for (int n = 0; n < 3; ++n) r = fmaf(r, fmaf(-y, r, 1.f), r);
  *f = 4.f * r * (1.f - r);
  return fmaf(r, -2.f * p.score_mul, p.score_mul);
}

// bf16 A operands of wgmma from an accumulator: chunks 2 kk and 2 kk + 1 of
// a 64 x N result are the 16 columns of k-step kk.
template <int N>
__device__ __forceinline__ void to_a(const float (&x)[N],
                                     uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// dK and dV: one block per (b, KV head, 64 keys, head split).  K and V stay
// resident; the ring streams 64-row tiles of Q and dO (every live q tile of
// each query head of the split).  The two consumer warpgroups split the
// work by role, so neither waits on the other's products:
//   warpgroup 0: S^T = K Q^T by wgmma (both K-major); P = 2^(s - lse) in
//     registers, masked; P f (f: the softcap factor 1 - tanh^2, else 1) to
//     shared memory for warpgroup 1; dV += P^T dO with P^T (bf16) from
//     registers and dO MN-major.
//   warpgroup 1: dP^T = V dO^T; dS = P f (dP - delta) with warpgroup 0's
//     P f; dK += dS^T Q, dS^T (bf16) from registers, Q MN-major.
// P f goes through two 16 KB buffers, each thread's 32 values at the slots
// its twin in the other warpgroup reads (the two hold the same elements of
// the 64 x 64 tile), with mbarriers for "full" and "empty".  dV and dK (64
// x D: D / 2 floats a thread) stay in registers for the whole loop.
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const BwdParams p) {
  constexpr int NST = dkdv_stages<D>(), DP = padded<D>();
  constexpr uint32_t TB = 128 * DP;         // one 64-row tile of DP columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + TB;
  const uint32_t sT = sV + TB;              // stage s: Q at sT + 2 s TB,
                                            // dO at sT + (2 s + 1) TB
  const uint32_t sX = sT + 2 * NST * TB;    // P f: 2 buffers of 16 KB
  const uint32_t sSt = sX + 2 * 16384;      // lse, delta: 512 B a stage
  const uint32_t bar_r = sSt + 512 * NST;
  const uint32_t full = bar_r + 8;          // stage s at + 8 s
  const uint32_t empty = full + 8 * NST;
  const uint32_t x_full = empty + 8 * NST;  // P f buffer x at + 8 x
  const uint32_t x_empty = x_full + 16;
  float* st_gen = reinterpret_cast<float*>(smem_raw + (sSt - base));
  float4* x_gen = reinterpret_cast<float4*>(smem_raw + (sX - base));

  const int G = p.H / p.KV, per = G / p.nsplit;
  // every head and split of a key tile before the next, the heaviest
  // causal tile first
  const int kt = blockIdx.y;
  const int split = blockIdx.x % p.nsplit;
  const int b = blockIdx.x / p.nsplit / p.KV;
  const int hk = blockIdx.x / p.nsplit % p.KV;
  const int h0 = hk * G + split * per;
  const int nq = (p.Sq + kT - 1) / kT;
  // item n: q tile n % nq of query head h0 + n / nq

  if (threadIdx.x == 0) {
    mbar_init(bar_r, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 1 + 32);      // TMA bytes + the stats warp
      mbar_init(empty + 8 * s, 8);          // lane 0 of each consumer warp
    }
    for (int x = 0; x < 2; ++x) {
      mbar_init(x_full + 8 * x, 128);       // every thread of warpgroup 0
      mbar_init(x_empty + 8 * x, 128);      // every thread of warpgroup 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread starts every TMA load; a second warp writes
    // each stage's row statistics (lse in log2 units, delta).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_r, 2 * TB);
      for (int c = 0; c < DP / 64; ++c) {
        tma_load(sK + c * kBoxBytes, &tm_k, bar_r, 64 * c, kt * kT, hk, b);
        tma_load(sV + c * kBoxBytes, &tm_v, bar_r, 64 * c, kt * kT, hk, b);
      }
      for (int n = 0, it = 0; n < per * nq; ++n) {
        if (!w_live(p, n % nq, kt, kT, p.kb)) continue;
        const int s = it % NST, round = it / NST;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * TB);
        const uint32_t dst = sT + 2 * s * TB;
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(dst + c * kBoxBytes, &tm_q, full + 8 * s, 64 * c,
                   n % nq * kT, h0 + n / nq, b);
          tma_load(dst + TB + c * kBoxBytes, &tm_do, full + 8 * s, 64 * c,
                   n % nq * kT, h0 + n / nq, b);
        }
        ++it;
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      const int lane = threadIdx.x - 32;
      for (int n = 0, it = 0; n < per * nq; ++n) {
        if (!w_live(p, n % nq, kt, kT, p.kb)) continue;
        const int s = it % NST, round = it / NST;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const size_t row0 = ((size_t)b * p.H + h0 + n / nq) * p.Sq;
        float* st = st_gen + 128 * s;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h, i = n % nq * kT + r;
          st[r] = i < p.Sq ? p.lse[row0 + i] * kLog2e : 0.f;
          st[kT + r] = i < p.Sq ? p.delta[row0 + i] : 0.f;
        }
        mbar_arrive(full + 8 * s);
        ++it;
      }
    }
    return;
  }

  // Consumers: thread (warp, g, t) of warpgroup cw holds keys k0 + ra and
  // k0 + rb (ra = 16 warp + g, rb = ra + 8) and, in every 8-column chunk j
  // of a product, the columns 8 j + 2 t and 8 j + 2 t + 1.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * warp + g, rb = ra + 8;

  float acc[D / 2];                         // dV (warpgroup 0) or dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t sa = cw ? sV : sK;         // the score product's A
  mbar_wait(bar_r, 0);

  for (int n = 0, it = 0; n < per * nq; ++n) {
    const int qt = n % nq;
    if (!w_live(p, qt, kt, kT, p.kb)) continue;
    const int s = it % NST, x = it & 1;
    const uint32_t xpar = (it >> 1) & 1;
    const uint32_t tq = sT + 2 * s * TB, tdo = tq + TB;
    mbar_wait(full + 8 * s, (it / NST) & 1);

    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T (64 x 64)
    float sc[32];
    const uint32_t sb = cw ? tdo : tq;
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D; kd += 16) {
      const uint32_t ro = (kd / 64) * kBoxBytes + (kd % 64) * 2;
      wgmma_ss(sc, sw128_desc(sa + ro, 16, 1024),
               sw128_desc(sb + ro, 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // columns c(i) = 8 (i / 4) + 2 t + (i & 1): this tile's q rows
    const float* st = st_gen + 128 * s;
    float4* xb = x_gen + x * 1024;
    if (cw == 0) {
      float f[32];                          // P f
      if (p.softcap != 0.f) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float s2 = capped_log2(p, sc[i], &f[i]);
          sc[i] = ex2(s2 - st[(i / 4) * 8 + 2 * t + (i & 1)]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = ex2(sc[i] * p.score_mul - st[(i / 4) * 8 + 2 * t + (i & 1)]);
          f[i] = 1.f;
        }
      }
      if (w_edge(p, qt, kt, kT, p.kb)) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (!w_pair_ok(p, qt * kT + (i / 4) * 8 + 2 * t + (i & 1),
                         kt * kT + ((i & 2) ? rb : ra)))
            sc[i] = 0.f;
      }
      if (it >= 2) mbar_wait(x_empty + 8 * x, xpar ^ 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xb[j * 128 + tid] = make_float4(sc[4 * j] * f[4 * j],
                                        sc[4 * j + 1] * f[4 * j + 1],
                                        sc[4 * j + 2] * f[4 * j + 2],
                                        sc[4 * j + 3] * f[4 * j + 3]);
      mbar_arrive(x_full + 8 * x);
    } else {
      mbar_wait(x_full + 8 * x, xpar);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pf = xb[j * 128 + tid];
        const float v[4] = {pf.x, pf.y, pf.z, pf.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = v[e] * (sc[4 * j + e] -
                                  st[kT + 8 * j + 2 * t + (e & 1)]);
      }
      mbar_arrive(x_empty + 8 * x);
    }

    // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q (64 q rows, 4
    // steps of k16; A from registers, the streaming tile MN-major)
    uint32_t a[4][4];
    to_a(sc, a);
    const uint32_t bt = cw ? tq : tdo;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a[kk], sw128_desc(bt + kk * 16 * 128, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    ++it;
  }

  // warpgroup 0 holds dV, warpgroup 1 dK (times scale), for keys k0 + ra
  // and k0 + rb: into dK and dV, or into this split's partials
  const int k0 = kt * kT;
  const float mul = cw ? p.scale : 1.f;
  const size_t n = (size_t)p.B * p.Sk * p.KV * D;
  float* part = p.nsplit > 1
                    ? p.part + (2 * (size_t)split + (cw ? 0 : 1)) * n
                    : nullptr;
  bf16* out = cw ? (bf16*)p.dk + b * p.dk_b + hk * p.dk_h
                 : (bf16*)p.dv + b * p.dv_b + hk * p.dv_h;
  const int64_t out_s = cw ? p.dk_s : p.dv_s;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + (hf ? rb : ra);
    if (key >= p.Sk) continue;
    const size_t row = (((size_t)b * p.Sk + key) * p.KV + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * t;
      const float x0 = acc[4 * j + 2 * hf] * mul;
      const float x1 = acc[4 * j + 2 * hf + 1] * mul;
      if (p.nsplit == 1)
        *reinterpret_cast<uint32_t*>(out + key * out_s + d) =
            pack_bf16(x0, x1);
      else
        *reinterpret_cast<float2*>(part + row + d) = make_float2(x0, x1);
    }
  }
}

// dQ: one block per (b, head, 128 q rows), the forward's layout.  Q and dO
// stay resident; the ring streams K and V tiles of BK keys (48 at D = 256,
// else 64), every tile live for either 64-row half.  Consumer warpgroup cw
// owns q rows 64 cw .. 64 cw + 63 and needs nothing from the other: S = Q
// K^T and dP = dO V^T by wgmma (both K-major), dS = P (dP - delta) f with P
// = 2^(s - lse) in registers, then dQ += dS K with dS (bf16) from
// registers and K MN-major; dQ (64 x D, D / 2 floats a thread) stays in
// registers.
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const BwdParams p) {
  constexpr int BK = dq_key_tile<D>(), NST = dq_stages<D>();
  constexpr uint32_t QC = 128 * 128;        // 128 rows of one 64-column box
  constexpr uint32_t KC = BK * 128;         // BK rows of one box
  constexpr int DP = padded<D>();
  constexpr uint32_t QB = QC * (DP / 64), KB = KC * (DP / 64);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = ((uint32_t)__cvta_generic_to_shared(smem_raw) +
                       1023) & ~1023u;
  const uint32_t sdO = sQ + QB;
  const uint32_t sK = sdO + QB;             // stage s at + 2 s KB; V: + KB
  const uint32_t bar_r = sK + 2 * NST * KB;
  const uint32_t full = bar_r + 8;
  const uint32_t empty = full + 8 * NST;

  // every head of a q tile before the next, the heaviest causal tile first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int hk = h / (p.H / p.KV), g0 = q0 / kT;
  const int nk = (p.Sk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_r, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);          // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread starts every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_r, 2 * QB);
      for (int c = 0; c < DP / 64; ++c)
        for (int half = 0; half < 2; ++half) {
          tma_load(sQ + c * QC + half * kBoxBytes, &tm_q, bar_r, 64 * c,
                   q0 + 64 * half, h, b);
          tma_load(sdO + c * QC + half * kBoxBytes, &tm_do, bar_r, 64 * c,
                   q0 + 64 * half, h, b);
        }
      for (int j = 0, it = 0; j < nk; ++j) {
        if (!w_live(p, g0, j, BK, p.kbd) && !w_live(p, g0 + 1, j, BK, p.kbd))
          continue;
        const int s = it % NST, round = it / NST;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * KB);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(sK + 2 * s * KB + c * KC, &tm_k, full + 8 * s, 64 * c,
                   j * BK, hk, b);
          tma_load(sK + (2 * s + 1) * KB + c * KC, &tm_v, full + 8 * s,
                   64 * c, j * BK, hk, b);
        }
        ++it;
      }
    }
    return;
  }

  // Consumers: thread (warp, g, t) of warpgroup cw holds q rows row0 = q0 +
  // 64 cw + 16 warp + g and row1 = row0 + 8, and in every 8-column chunk j
  // of a product the columns 8 j + 2 t and 8 j + 2 t + 1.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = q0 + 64 * cw + 16 * warp + lane / 4, row1 = row0 + 8;
  const size_t srow = ((size_t)b * p.H + h) * p.Sq;
  float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  if (row0 < p.Sq) {
    lse0 = p.lse[srow + row0] * kLog2e;
    dl0 = p.delta[srow + row0];
  }
  if (row1 < p.Sq) {
    lse1 = p.lse[srow + row1] * kLog2e;
    dl1 = p.delta[srow + row1];
  }
  const uint32_t qa = sQ + 64 * cw * 128, da = sdO + 64 * cw * 128;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_r, 0);

  for (int j = 0, it = 0; j < nk; ++j) {
    if (!w_live(p, g0, j, BK, p.kbd) && !w_live(p, g0 + 1, j, BK, p.kbd))
      continue;
    const int s = it % NST;
    const uint32_t ks = sK + 2 * s * KB, vs = ks + KB;
    mbar_wait(full + 8 * s, (it / NST) & 1);
    if (w_live(p, g0 + cw, j, BK, p.kbd)) {
      // S = Q K^T and dP = dO V^T: 64 x BK, D / 16 steps of k16
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D; kd += 16) {
        const uint32_t qo = (kd / 64) * QC + (kd % 64) * 2;
        const uint32_t ko = (kd / 64) * KC + (kd % 64) * 2;
        wgmma_ss(sc, sw128_desc(qa + qo, 16, 1024),
                 sw128_desc(ks + ko, 16, 1024), kd > 0);
      }
#pragma unroll
      for (int kd = 0; kd < D; kd += 16) {
        const uint32_t qo = (kd / 64) * QC + (kd % 64) * 2;
        const uint32_t ko = (kd / 64) * KC + (kd % 64) * 2;
        wgmma_ss(dp, sw128_desc(da + qo, 16, 1024),
                 sw128_desc(vs + ko, 16, 1024), kd > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // dS = 2^(s - lse) (dP - delta) f into dp; 0 where masked
      if (p.softcap != 0.f) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float f;
          const float s2 = capped_log2(p, sc[i], &f);
          dp[i] = ex2(s2 - ((i & 2) ? lse1 : lse0)) *
                  (dp[i] - ((i & 2) ? dl1 : dl0)) * f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          dp[i] = ex2(sc[i] * p.score_mul - ((i & 2) ? lse1 : lse0)) *
                  (dp[i] - ((i & 2) ? dl1 : dl0));
      }
      if (w_edge(p, g0 + cw, j, BK, p.kbd)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (!w_pair_ok(p, (i & 2) ? row1 : row0,
                         j * BK + (i / 4) * 8 + 2 * t + (i & 1)))
            dp[i] = 0.f;
      }

      // dQ += dS K: BK / 16 steps of k16, K MN-major
      uint32_t a[BK / 16][4];
      to_a(dp, a);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, a[kk], sw128_desc(ks + kk * 16 * 128, KC, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    ++it;
  }

  bf16* out = (bf16*)p.dq + b * p.dq_b + h * p.dq_h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = hf ? row1 : row0;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (int64_t)row * p.dq_s + 8 * j +
                                   2 * t) =
          pack_bf16(acc[4 * j + 2 * hf] * p.scale,
                    acc[4 * j + 2 * hf + 1] * p.scale);
  }
}

// delta_i = dO_i . O_i for every (b, h, query row i), O the forward's fp32
// output (o32, [B, Sq, H, D] contiguous), into p.delta [B, H, Sq]: one
// warp a row, 8 columns a lane at a time, summed in a fixed order.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const BwdParams p) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)p.B * p.H * p.Sq) return;
  const int i = (int)(row % p.Sq);
  const int bh = (int)(row / p.Sq), b = bh / p.H, h = bh % p.H;
  const bf16* dg = (const bf16*)p.dout + b * p.do_b + i * p.do_s +
                   h * p.do_h;
  const float* og = p.o32 + (((int64_t)b * p.Sq + i) * p.H + h) * D;
  float acc = 0.f;
  for (int d = 8 * lane; d < D; d += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(dg + d);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 o0 = *reinterpret_cast<const float4*>(og + d);
    const float4 o1 = *reinterpret_cast<const float4*>(og + d + 4);
    const float2 e0 = __bfloat1622float2(e[0]), e1 = __bfloat1622float2(e[1]);
    const float2 e2 = __bfloat1622float2(e[2]), e3 = __bfloat1622float2(e[3]);
    acc = fmaf(e0.x, o0.x, acc);
    acc = fmaf(e0.y, o0.y, acc);
    acc = fmaf(e1.x, o0.z, acc);
    acc = fmaf(e1.y, o0.w, acc);
    acc = fmaf(e2.x, o1.x, acc);
    acc = fmaf(e2.y, o1.y, acc);
    acc = fmaf(e3.x, o1.z, acc);
    acc = fmaf(e3.y, o1.w, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) p.delta[row] = acc;
}

template <typename Kernel>
cudaError_t launch_w(Kernel kernel, dim3 grid, size_t smem,
                     const CUtensorMap (&tm)[4], const BwdParams& p,
                     cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWThreads, smem, s>>>(tm[0], tm[1], tm[2], tm[3], p);
  return cudaGetLastError();
}

// The bf16 backward: with positions, the position bounds of 64-row chunks
// (q and dkdv's keys) and of dq's key tiles; then delta, dq, dkdv and, for
// several head splits, the reduce.  bounds holds 2 * (ceil(S / 64) +
// ceil(S / 48)) ints.
template <int D>
int launch_wgmma(BwdParams p, void* bounds, cudaStream_t s) {
  constexpr int BK = dq_key_tile<D>();
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap tm[4], td[4];           // q, k, v, dout: 64-row boxes; dq's
  if (!encode_map(encode, &tm[0], p.q, D, p.Sq, p.H, p.B, p.q_s, p.q_h,
                  p.q_b, kT) ||
      !encode_map(encode, &tm[1], p.k, D, p.Sk, p.KV, p.B, p.k_s, p.k_h,
                  p.k_b, kT) ||
      !encode_map(encode, &tm[2], p.v, D, p.Sk, p.KV, p.B, p.v_s, p.v_h,
                  p.v_b, kT) ||
      !encode_map(encode, &tm[3], p.dout, D, p.Sq, p.H, p.B, p.do_s,
                  p.do_h, p.do_b, kT) ||
      !encode_map(encode, &td[1], p.k, D, p.Sk, p.KV, p.B, p.k_s, p.k_h,
                  p.k_b, BK) ||
      !encode_map(encode, &td[2], p.v, D, p.Sk, p.KV, p.B, p.v_s, p.v_h,
                  p.v_b, BK))
    return (int)cudaErrorInvalidValue;
  td[0] = tm[0];
  td[3] = tm[3];
  const int nk = (p.Sk + kT - 1) / kT;
  if (p.pos) {                        // Sq == Sk
    const int nd = (p.Sk + BK - 1) / BK;
    int* kb = (int*)bounds;
    p.kb = p.qb = kb;
    p.kbd = kb + 2 * nk;
    pos_bounds_kernel<<<(nk + 127) / 128, 128, 0, s>>>(p.pos, p.Sk, kT, nk,
                                                       kb);
    pos_bounds_kernel<<<(nd + 127) / 128, 128, 0, s>>>(p.pos, p.Sk, BK, nd,
                                                       kb + 2 * nk);
  }
  const int64_t rows = (int64_t)p.B * p.H * p.Sq;
  flash_bwd_delta<D><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_w(flash_bwd_dq_wgmma<D>,
                   dim3(p.B * p.H, (p.Sq + 127) / 128), dq_smem_bytes<D>(),
                   td, p, s);
  if (err == cudaSuccess)
    err = launch_w(flash_bwd_dkdv_wgmma<D>,
                   dim3(p.B * p.KV * p.nsplit, nk), dkdv_smem_bytes<D>(), tm,
                   p, s);
  if (err == cudaSuccess && p.nsplit > 1) {
    flash_bwd_reduce_kernel<bf16, D><<<264, kThreads, 0, s>>>(p);
    err = cudaGetLastError();
  }
  return (int)err;
}

int launch_wgmma_d(const BwdParams& p, int D, void* bounds,
                   cudaStream_t s) {
  switch (D) {
    case 16: return launch_wgmma<16>(p, bounds, s);
    case 32: return launch_wgmma<32>(p, bounds, s);
    case 64: return launch_wgmma<64>(p, bounds, s);
    case 80: return launch_wgmma<80>(p, bounds, s);
    case 128: return launch_wgmma<128>(p, bounds, s);
    case 256: return launch_wgmma<256>(p, bounds, s);
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
    case 16: return launch_fma<16>(p, s);
    case 32: return launch_fma<32>(p, s);
    case 64: return launch_fma<64>(p, s);
    case 80: return launch_fma<80>(p, s);
    case 128: return launch_fma<128>(p, s);
    case 256: return launch_fma<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, o, dout, dq are [B, Sq, H, D]
// views and k, v, dk, dv [B, Sk, KV, D] views given by their strides
// (strides: 24 int64, three (b, s, head) triples in the order q, k, v, o,
// dout, dq, dk, dv; D contiguous).  partials is fp32 scratch of
// 2 * nsplit * B * Sk * KV * D elements when nsplit > 1 (else unused), with
// nsplit dividing H / KV.  positions (int32 [S], Sq == Sk) masks by
// position when not null, with bounds int32 scratch (bf16: 2 * (ceil(S /
// 64) + ceil(S / 48)) elements; fp32: 2 * (ceil(Sk / 32) + ceil(Sq /
// 64))).
//   bf16 (wgmma): o32 and lse are the forward's fp32 output ([B, Sq, H, D],
//     contiguous) and rows' logsumexp ([B, H, Sq]) from
//     flash_attention_stats_launch; stats is fp32 scratch of B * H * Sq
//     elements (delta); o is not read.  q, k, v and dout must be views
//     TMA can map (16-byte aligned, strides multiples of 16 bytes).
//   fp32 (FMAs): o32 and lse are not read; stats is fp32 scratch of
//     3 * B * H * Sq elements.
// Launches on `stream` and returns the CUDA error (0 when every launch
// was accepted).
extern "C" int flash_attention_grad_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* o32, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, int B, int H, int KV, int Sq, int Sk, int D,
    const int64_t* strides, float scale, float softcap, int causal,
    int window, int dtype_bf16, const void* positions, void* bounds,
    void* stats, void* partials, int nsplit, void* stream) {
  if (KV <= 0 || H % KV || nsplit < 1 || (H / KV) % nsplit ||
      (positions && Sq != Sk) || (dtype_bf16 && (!o32 || !lse)))
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
  p.kb = p.qb = p.kbd = nullptr;
  p.o32 = (const float*)o32;
  p.lse = (const float*)lse;
  p.delta = (float*)stats;
  p.score_mul = (softcap != 0.f ? softcap : scale) * kLog2e;
  p.tanh_mul = softcap != 0.f ? 2.f * kLog2e * scale / softcap : 0.f;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype_bf16) return launch_wgmma_d(p, D, bounds, s);
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
  return launch_fma_d(p, D, s);
}
