// Forward flash attention for Hopper (sm_90a): blockwise online softmax.
//
// Replaces the Pallas TPU kernel flash_attention (_flash_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py, and with it the
// jnp.repeat of the KV heads in kernels/flash_attention/ops.py: this kernel
// reads KV head h / (H / KV) for query head h instead.
//
// What it computes, for each (batch b, query head h, query row i):
//   s_ij = (q_i . k_j) * scale, then softcap * tanh(s_ij / softcap) if a
//   softcap is set, then NEG_INF where key j is masked (causal: j > i;
//   window: j <= i - window); out_i = sum_j p_ij v_j / sum_j p_ij with the
//   online-softmax recurrence of the TPU kernel.  Positions count from 0 on
//   both sides.  Numerics follow the TPU kernel: q and k enter the product
//   as bf16 with an fp32 sum (bf16 products are exact in fp32), the running
//   max m, the denominator l and the accumulator are fp32, p is rounded to
//   v's dtype before p.v, l is clamped at 1e-30, and the output is in q's
//   dtype.
//
// The masked value is the finite NEG_INF = -1e38, never -inf.  A row whose
// entries are all masked in a live tile gets m_new = NEG_INF and
// p = exp(0) = 1; a later tile of the same row holds a live key and wipes
// that with corr = exp(NEG_INF - m) = 0, so masked entries add exactly
// nothing.  With -inf the same code would give NaN.
//
// What bounds it on an H100 SXM: operations.  A causal layer of gemma2-9b's
// prefill (B=1, H=16, D=256, S=8192) has 33.6 M live (q, k) pairs per head,
// 4*D FLOP each: 5.5e11 FLOP, 0.556 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 0.10 ms to move q, k, v and o once at 3.35 TB/s.
// Only wgmma reaches that rate, so both products run on it.
//
// The TPU walks KV blocks in a sequential grid dimension and carries m, l
// and acc in VMEM scratch; here one thread block owns one (b*h, q tile)
// and loops over the KV tiles itself, skipping tiles that are causally or
// window-dead, so nothing crosses blocks.  Blocks run heaviest causal q
// tiles first, over all heads, before any lighter one.
//   bf16 (D = 64, 80, 128, 256; one kernel): 128 q rows a block, three
//     warpgroups.  A producer warpgroup (40 registers a thread after
//     setmaxnreg) has one thread start every copy by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, zero fill past the ends of
//     the sequence): Q once, then K and V tiles of 80 keys through a ring
//     of stages (2 at D = 256, 4 at D = 128, 8 at D = 64), each stage with
//     mbarriers for "K full", "V full" and "empty", so the next tile loads
//     while this one is used.  A row of D = 256 is 512 bytes, so each tile
//     arrives as D / 64 boxes of 64 columns.  Two consumer warpgroups (232
//     registers) own 64 q rows each: S = Q K^T by wgmma m64n80k16 with Q
//     and K from shared memory (both K-major), the softmax in registers,
//     then O += P V by wgmma m64nDk16 with P from registers (bf16) and V
//     from shared memory through the transpose bit; the D / 2 fp32
//     accumulators of O stay in registers.  D = 80 (hubert-xlarge's
//     heads) keeps the D = 128 shared-memory layout, padded: the tensor
//     maps keep the real 80 columns, so TMA zero-fills columns 80..127 of
//     the second box.  The products run at the real width: Q K^T over
//     five k16 steps, P V as m64n80k16 (V's first 64-column swizzle atom
//     and 16 columns of the next), and every access by address (the
//     epilogue, o32) stops at column 80.  P V over all 128 columns was
//     7-15% slower at hubert's prefill shape (PERF.md, section 6).
//     Masks are applied only on edge tiles (the causal diagonal, the
//     window's lower edge, the ragged end of the keys); interior tiles
//     skip the compares.  The softmax works
//     in log2 units: scale * log2(e) is one multiply, the exponentials are
//     ex2.approx, and the softcap cap * tanh(s / cap) is formed as in
//     softcap_log2 (two ex2 a score, the reciprocal on the FMA pipe, tanh
//     within 3e-7 of libm's).
//     The two consumer warpgroups wait on the same tile and run in step,
//     so the softmax is not hidden behind the other's products (on the
//     H100, PERF.md: 0.75 ms of products and loads plus 0.1-0.3 ms of
//     softmax for a gemma2-9b layer).  Ping-pong turns between them
//     measured no faster at N = 64 once ptxas no longer serialised their
//     wgmma; issuing S(j+1) before softmax(j) stayed serialised and slower.
//     80-key tiles (the most that two stages fit at D = 256) are 2-8%
//     faster than 64.  A branch whose
//     condition ptxas cannot prove uniform, or an operand register written
//     between wgmma.fence and the wait, makes ptxas serialise the wgmma
//     ("Potential Performance Loss" in -Xptxas -v): keep each product's
//     fence .. wait window straight-line.
//   fp32: 8 warps, plain IEEE fp32 FMAs (no TF32), 32-key tiles loaded by
//     cp.async; four threads share a q row, each holding 8 scores and D / 4
//     accumulators (D = 80: 20, no padding).
//
// Statistics for the backward (flash_attention_stats_launch, bf16): when
// autograd records the call, the epilogue also writes each row's logsumexp
// m + ln(l) (fp32 [B, H, Sq], natural-log units) and the output before its
// bf16 rounding (fp32 [B, Sq, H, D]), so the backward neither recomputes
// the row statistics nor reads delta from the rounded output.  Null
// pointers (the other entry points) leave every output bit as it was.
//
// Masks by position (flash_attention_pos_launch): the JAX package's default
// attention path masks by positions, one int32 vector pos[S] for queries
// and keys (the temporal row of M-RoPE's positions, where an image's
// patches share one id), not by index.  Both kernels take it as a second
// template instance (kPos), so the index instance compiles as before.  A
// first small kernel (pos_bounds_kernel) writes the least and greatest
// position of every key tile and of every 64-row q group; a tile is dead
// for a group when no pair can pass the masks (causal: min key > max
// query; window: max key <= min query - window) and needs no element mask
// when every pair passes (max key <= min query; min key > max query -
// window).  So any int32 positions (repeated, non-monotone, with gaps)
// give the plain version's result, and tiles are skipped where the
// positions allow.  In the bf16 kernel the producer and both consumer
// warpgroups decide a tile's liveness for the block from the same bounds
// in device memory, so they agree on the tiles that pass through the ring.
#include <cuda.h>                     // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

#include "hopper.cuh"                 // TMA, mbarriers, wgmma

namespace {

constexpr float kNegInf = -1.0e38f;   // _flash_kernel's NEG_INF
constexpr int kBQ = 64;               // q rows per block (fp32)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // strides in elements of [B, S, heads, D] views; D is contiguous
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int H, KV, Sq, Sk;
  float scale, softcap;
  int causal, window;
  // kPos only: positions [Sq] (== [Sk]); min and max position of each key
  // tile (kb) and of each 64-row q group (qb), interleaved
  const int* pos;
  const int* kb;
  const int* qb;
  // bf16 only, for the backward when not null: each row's logsumexp of
  // its scores (fp32 [B, H, Sq]) and the fp32 output before its bf16
  // rounding ([B, Sq, H, D], contiguous)
  float* lse;
  float* o32;
};

// kPos: may a query at position qp see a key at position kp?  In 64 bits,
// so that qp - window cannot wrap.
__device__ __forceinline__ bool pos_ok(int causal, int window, int qp,
                                       int kp) {
  bool ok = true;
  if (causal) ok = kp <= qp;
  if (window) ok = ok && (long long)kp > (long long)qp - window;
  return ok;
}

// kPos: is key tile j live for q group g (some pair may pass the masks)?
// A group that starts past the last query is dead.
template <typename P>
__device__ __forceinline__ bool pos_live(const P& p, int j, int g) {
  if (g * 64 >= p.Sq) return false;
  const int klo = p.kb[2 * j], khi = p.kb[2 * j + 1];
  const int qlo = p.qb[2 * g], qhi = p.qb[2 * g + 1];
  bool live = true;
  if (p.causal) live = klo <= qhi;
  if (p.window) live = live && (long long)khi > (long long)qlo - p.window;
  return live;
}

// kPos: does key tile j need element masks for q group g (some pair of a
// live tile fails them)?
template <typename P>
__device__ __forceinline__ bool pos_edge(const P& p, int j, int g) {
  const int klo = p.kb[2 * j], khi = p.kb[2 * j + 1];
  const int qlo = p.qb[2 * g], qhi = p.qb[2 * g + 1];
  bool edge = false;
  if (p.causal) edge = khi > qlo;
  if (p.window) edge = edge || (long long)klo <= (long long)qhi - p.window;
  return edge;
}

// The least and greatest of pos[t * tile .. min(S, (t + 1) * tile)) for
// each of the n tiles, interleaved into out[2 t], out[2 t + 1].
__global__ void pos_bounds_kernel(const int* __restrict__ pos, int S,
                                  int tile, int n, int* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  int lo = INT_MAX, hi = INT_MIN;
  const int end = min(S, (t + 1) * tile);
  for (int i = t * tile; i < end; ++i) {
    const int v = pos[i];
    lo = min(lo, v);
    hi = max(hi, v);
  }
  out[2 * t] = lo;
  out[2 * t + 1] = hi;
}

__device__ __forceinline__ bool tile_live(const Params& p, int q0, int k0,
                                          int bk) {
  bool live = true;
  if (p.causal) live = k0 <= q0 + kBQ - 1;
  if (p.window) live = live && (k0 + bk - 1 > q0 - p.window);
  return live;
}

// s * scale, the softcap, then the mask, in _flash_kernel's order.
__device__ __forceinline__ float score(const Params& p, float dot, int qp,
                                       int kp) {
  float s = dot * p.scale;
  if (p.softcap != 0.f) s = p.softcap * tanhf(s / p.softcap);
  bool ok = kp < p.Sk;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window) ok = ok && kp > qp - p.window;
  return ok ? s : kNegInf;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Asynchronous global -> shared copies (cp.async): a thread starts all of
// its copies of a tile before any completes, so a tile costs about one
// memory latency rather than one per copy.  `in_range` false zero-fills.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool in_range) {
  const uint32_t saddr = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(saddr), "l"(src), "n"(BYTES),
                  "r"(in_range ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kBQ16 = 128;            // q rows per block: 2 warpgroups of 64
constexpr int kBK16 = 80;             // keys per KV tile
constexpr int kThreads16 = 384;       // producer + two consumer warpgroups
constexpr int kBox = 64;              // columns per TMA box: 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The width a head of D columns takes in shared memory: whole 64-column
// boxes (80 -> 128; the rest are D itself).
template <int D>
__host__ __device__ constexpr int padded() {
  return (D + kBox - 1) / kBox * kBox;
}

// Stages of the K/V ring: what fits in 227 KB beside the 128-row Q tile
// (D = 256: 64 KB of Q and 2 x 80 KB of K and V, 230,456 bytes in all).
template <int D>
__host__ __device__ constexpr int ring_stages() {
  return padded<D>() == 256 ? 2 : padded<D>() == 128 ? 4 : 8;
}

// Q, the K and V rings, 3 mbarriers a stage plus Q's, and slack to align
// the tiles to 1024 bytes (the 128-byte swizzle's period).
template <int D>
constexpr size_t bf16_smem_bytes() {
  return 1024 +
         2 * (size_t)padded<D>() * (kBQ16 + 2 * ring_stages<D>() * kBK16) +
         8 * (1 + 3 * ring_stages<D>());
}

struct Bf16Params {
  void* o;
  int64_t o_b, o_s, o_h;              // output strides in elements
  int H, KV, Sq, Sk;
  int causal, window, softcap;        // softcap: nonzero when a cap is set
  float score_mul;                    // (softcap ? cap : scale) * log2(e)
  float tanh_mul;                     // 2 log2(e) scale / cap
  const int* pos;                     // kPos only, as in Params
  const int* kb;
  const int* qb;
  float* lse;                         // as in Params, or null
  float* o32;
};

// cap * log2(e) * tanh(s / cap) for the raw dot product q.k, s = dot *
// scale: with u = 2^(dot * k) = e^(2 s / cap) (k = 2 log2(e) scale / cap),
// tanh = 1 - 2 / (1 + u), which saturates to +-1 without NaN.  The
// reciprocal runs on the FMA pipe (a bit-trick seed within 5%, then three
// Newton steps: relative error under 1e-7, tanh within 3e-7) so that a
// score costs two MUFU ops (both ex2.approx), not three.
__device__ __forceinline__ float softcap_log2(float dot, float k, float sm) {
  const float y = fminf(1.f + ex2(dot * k), 1e30f);
  float r = __int_as_float(0x7EF311C3 - __float_as_int(y));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fmaf(r, fmaf(-y, r, 1.f), r);
  return fmaf(r, -2.f * sm, sm);
}

template <int D, bool kPos>
__global__ void __launch_bounds__(kThreads16, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const Bf16Params p) {
  constexpr int NST = ring_stages<D>(), DP = padded<D>();
  constexpr uint32_t QBYTES = 2 * kBQ16 * DP, TBYTES = 2 * kBK16 * DP;
  constexpr uint32_t QBOX = 2 * kBQ16 * kBox, TBOX = 2 * kBK16 * kBox;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023) &
                      ~1023u;
  const uint32_t sK = sQ + QBYTES;          // stage s at sK + s * TBYTES
  const uint32_t sV = sK + NST * TBYTES;
  const uint32_t bar_q = sV + NST * TBYTES;
  const uint32_t full_k = bar_q + 8;        // stage s at + 8 * s
  const uint32_t full_v = full_k + 8 * NST;
  const uint32_t empty = full_v + 8 * NST;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ16;   // heaviest first
  // the KV tiles live for some row of the block: [lo, hi] (kPos: every
  // tile, each tested by pos_live for the block's two q groups)
  int lo = 0, hi = (p.Sk + kBK16 - 1) / kBK16 - 1;
  if constexpr (!kPos) {
    if (p.causal) hi = min(hi, (q0 + kBQ16 - 1) / kBK16);
    if (p.window) {
      const int first = q0 - p.window - kBK16 + 2;  // least live tile start
      if (first > 0) lo = (first + kBK16 - 1) / kBK16;
    }
  }
  const int g0 = q0 / 64;                 // the q groups of the warpgroups

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);          // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread starts every load; the ring's "empty" barriers
    // hold it until both consumer warpgroups are done with a stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, QBYTES);
      for (int c = 0; c < DP / kBox; ++c)
        tma_load(sQ + c * QBOX, &tm_q, bar_q, c * kBox, q0, h, b);
      for (int j = lo, it = 0; j <= hi; ++j) {
        if constexpr (kPos) {
          if (!pos_live(p, j, g0) && !pos_live(p, j, g0 + 1)) continue;
        }
        const int s = it % NST, round = it / NST;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full_k + 8 * s, TBYTES);
        for (int c = 0; c < DP / kBox; ++c)
          tma_load(sK + s * TBYTES + c * TBOX, &tm_k, full_k + 8 * s,
                   c * kBox, j * kBK16, hk, b);
        mbar_expect_tx(full_v + 8 * s, TBYTES);
        for (int c = 0; c < DP / kBox; ++c)
          tma_load(sV + s * TBYTES + c * TBOX, &tm_v, full_v + 8 * s,
                   c * kBox, j * kBK16, hk, b);
        ++it;
      }
    }
  } else {
    // Consumers: warpgroup cw owns q rows r0 .. r0 + 63; thread (warp,
    // g, t) holds rows row0 = r0 + 16 warp + g and row1 = row0 + 8, and in
    // every 8-column chunk j of S and O the columns 8j + 2t and 8j + 2t + 1
    // (the wgmma accumulator layout).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * cw;
    const int row0 = r0 + 16 * warp + g, row1 = row0 + 8;
    const uint32_t qa = sQ + 64 * cw * 128;
    int qpos0 = 0, qpos1 = 0;               // kPos: the rows' positions
    if constexpr (kPos) {
      if (row0 < p.Sq) qpos0 = p.pos[row0];
      if (row1 < p.Sq) qpos1 = p.pos[row1];
    }

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(bar_q, 0);

    for (int j = lo, it = 0; j <= hi; ++j) {
      if constexpr (kPos) {
        if (!pos_live(p, j, g0) && !pos_live(p, j, g0 + 1)) continue;
      }
      const int s = it % NST;
      const uint32_t par = (it / NST) & 1;
      const int k0 = j * kBK16;
      const uint32_t ks = sK + s * TBYTES, vs = sV + s * TBYTES;
      bool live = true;                     // for this warpgroup's rows
      if constexpr (kPos) {
        live = pos_live(p, j, g0 + cw);
      } else {
        if (p.causal) live = k0 <= r0 + 63;
        if (p.window) live = live && (k0 + kBK16 - 1 > r0 - p.window);
      }
      mbar_wait(full_k + 8 * s, par);
      if (live) {
        // S = Q K^T: 64 x kBK16, D / 16 steps of k16 (the real depth)
        float sc[kBK16 / 2];
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D; kd += 16)
          wgmma_ss(sc,
                   sw128_desc(qa + (kd / kBox) * QBOX + (kd % kBox) * 2,
                              16, 1024),
                   sw128_desc(ks + (kd / kBox) * TBOX + (kd % kBox) * 2,
                              16, 1024),
                   kd > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scores in log2 units: s * scale * log2(e), or the softcap's
        if (p.softcap) {
#pragma unroll
          for (int i = 0; i < kBK16 / 2; ++i)
            sc[i] = softcap_log2(sc[i], p.tanh_mul, p.score_mul);
        } else {
#pragma unroll
          for (int i = 0; i < kBK16 / 2; ++i) sc[i] *= p.score_mul;
        }
        // masks only on edge tiles: the ragged end of the keys, the causal
        // diagonal, the window's lower edge
        bool edge;
        if constexpr (kPos) {
          edge = k0 + kBK16 > p.Sk || pos_edge(p, j, g0 + cw);
        } else {
          edge = k0 + kBK16 > p.Sk || (p.causal && k0 + kBK16 - 1 > r0) ||
                 (p.window && k0 <= r0 + 63 - p.window);
        }
        if (edge) {
#pragma unroll
          for (int i = 0; i < kBK16 / 2; ++i) {
            const int kp = k0 + (i / 4) * 8 + 2 * t + (i & 1);
            bool ok = kp < p.Sk;
            if constexpr (kPos) {
              ok = ok && pos_ok(p.causal, p.window, (i & 2) ? qpos1 : qpos0,
                                p.pos[kp]);
            } else {
              const int qp = (i & 2) ? row1 : row0;
              if (p.causal) ok = ok && kp <= qp;
              if (p.window) ok = ok && kp > qp - p.window;
            }
            if (!ok) sc[i] = kNegInf;
          }
        }
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int i = 0; i < kBK16 / 2; i += 4) {
          mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int i = 0; i < kBK16 / 2; i += 4) {
          sc[i] = ex2(sc[i] - mn0);
          sc[i + 1] = ex2(sc[i + 1] - mn0);
          sc[i + 2] = ex2(sc[i + 2] - mn1);
          sc[i + 3] = ex2(sc[i + 3] - mn1);
          sum0 += sc[i] + sc[i + 1];
          sum1 += sc[i + 2] + sc[i + 3];
        }
        // l stays a per-thread partial sum (every thread of a row scales by
        // the same corr); the four partials of a row are added at the end.
        l0 = l0 * c0 + sum0;
        l1 = l1 * c1 + sum1;
        // bf16(P) as wgmma's register A operand: the accumulator chunks
        // 2kk and 2kk + 1 of S are the 16 keys of step kk
        uint32_t pa[kBK16 / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK16 / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
#pragma unroll
        for (int i = 0; i < D / 2; i += 4) {
          o[i] *= c0;
          o[i + 1] *= c0;
          o[i + 2] *= c1;
          o[i + 3] *= c1;
        }

        // O += P V: 5 steps of 16 keys, V MN-major (D contiguous)
        mbar_wait(full_v + 8 * s, par);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK16 / 16; ++kk)
          wgmma_rs(o, pa[kk], sw128_desc(vs + kk * 16 * 128, TBOX, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      } else {
        mbar_wait(full_v + 8 * s, par);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      ++it;
    }

    const float ls0 = quad_sum(l0), ls1 = quad_sum(l1);
    const float inv0 = 1.f / fmaxf(ls0, 1e-30f);
    const float inv1 = 1.f / fmaxf(ls1, 1e-30f);
    __nv_bfloat16* og = (__nv_bfloat16*)p.o + b * p.o_b + h * p.o_h;
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int d = 2 * i + 2 * t;          // chunk i / 4: columns 8 (i/4)
      if (row0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + row0 * p.o_s + d) =
            __floats2bfloat162_rn(o[i] * inv0, o[i + 1] * inv0);
      if (row1 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + row1 * p.o_s + d) =
            __floats2bfloat162_rn(o[i + 2] * inv1, o[i + 3] * inv1);
    }
    // for the backward: the logsumexp m + ln(l) of each row's scores (in
    // natural-log units: m is in log2 units here) and the output before
    // its rounding to bf16
    if (p.lse != nullptr && t == 0) {
      if (row0 < p.Sq)
        p.lse[(size_t)bh * p.Sq + row0] = (m0 + log2f(ls0)) * kLn2;
      if (row1 < p.Sq)
        p.lse[(size_t)bh * p.Sq + row1] = (m1 + log2f(ls1)) * kLn2;
    }
    if (p.o32 != nullptr) {
      float* o32 = p.o32 + ((size_t)b * p.Sq * p.H + h) * D;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        const int d = 2 * i + 2 * t;
        if (row0 < p.Sq)
          *reinterpret_cast<float2*>(o32 + (size_t)row0 * p.H * D + d) =
              make_float2(o[i] * inv0, o[i + 1] * inv0);
        if (row1 < p.Sq)
          *reinterpret_cast<float2*>(o32 + (size_t)row1 * p.H * D + d) =
              make_float2(o[i + 2] * inv1, o[i + 3] * inv1);
      }
    }
  }
}
// ---------------------------------------------------------------------------
// fp32: IEEE FMAs
// ---------------------------------------------------------------------------

constexpr int kBK32 = 32;             // keys per tile
constexpr int kThreads32 = 256;       // four threads per q row

template <int D, bool kPos>
__global__ void __launch_bounds__(kThreads32, 1)
flash_fwd_f32_kernel(const Params p) {
  constexpr int LQ = D + 1;           // padded rows: distinct banks
  constexpr int LP = kBK32 + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [kBQ][LQ]
  float* Ks = Qs + kBQ * LQ;                        // [kBK32][LQ]
  float* Vs = Ks + kBK32 * LQ;                      // [kBK32][D]
  float* Ps = Vs + kBK32 * D;                       // [kBQ][LP]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const int r = threadIdx.x / 4, cq = threadIdx.x % 4;
  const int qp = q0 + r;
  const int qpos = kPos && qp < p.Sq ? p.pos[qp] : 0;

  const float* qg = (const float*)p.q + b * p.q_b + h * p.q_h;
  const float* kg = (const float*)p.k + b * p.k_b + hk * p.k_h;
  const float* vg = (const float*)p.v + b * p.v_b + hk * p.v_h;
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads32) {
    const int rr = idx / D, d = idx % D;
    const bool in = q0 + rr < p.Sq;
    copy_async<4>(Qs + rr * LQ + d, in ? qg + (q0 + rr) * p.q_s + d : qg,
                  in);
  }
  copy_commit();

  float m = kNegInf, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  const int nk = (p.Sk + kBK32 - 1) / kBK32;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK32;
    if (kPos ? !pos_live(p, kt, qt) : !tile_live(p, q0, k0, kBK32))
      continue;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBK32 * D; idx += kThreads32) {
      const int rr = idx / D, d = idx % D;
      const bool in = k0 + rr < p.Sk;
      copy_async<4>(Ks + rr * LQ + d, in ? kg + (k0 + rr) * p.k_s + d : kg,
                    in);
      copy_async<4>(Vs + rr * D + d, in ? vg + (k0 + rr) * p.v_s + d : vg,
                    in);
    }
    copy_commit();
    copy_wait<0>();
    __syncthreads();

    // this thread's keys: cq, cq + 4, ..., cq + 28
    float s[kBK32 / 4];
#pragma unroll
    for (int j = 0; j < kBK32 / 4; ++j) s[j] = 0.f;
    const float* qr = Qs + r * LQ;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int j = 0; j < kBK32 / 4; ++j)
        s[j] = fmaf(qv, Ks[(cq + 4 * j) * LQ + d], s[j]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK32 / 4; ++j) {
      const int kp = k0 + cq + 4 * j;
      if constexpr (kPos) {
        s[j] *= p.scale;
        if (p.softcap != 0.f) s[j] = p.softcap * tanhf(s[j] / p.softcap);
        if (!(kp < p.Sk && pos_ok(p.causal, p.window, qpos, p.pos[kp])))
          s[j] = kNegInf;
      } else {
        s[j] = score(p, s[j], qp, kp);
      }
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, quad_max(mx));
    const float c = expf(m - mn);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK32 / 4; ++j) {
      const float e = expf(s[j] - mn);
      sum += e;
      Ps[r * LP + cq + 4 * j] = e;
    }
    l = l * c + sum;
    __syncwarp();                     // a row's four threads share one warp
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= c;
    const float* pr = Ps + r * LP;
    for (int kk = 0; kk < kBK32; ++kk) {
      const float pv = pr[kk];
      const float* vr = Vs + kk * D + cq;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc[i] = fmaf(pv, vr[4 * i], acc[i]);
    }
  }

  const float inv = 1.f / fmaxf(quad_sum(l), 1e-30f);
  if (qp < p.Sq) {
    float* og = (float*)p.o + b * p.o_b + h * p.o_h + qp * p.o_s;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) og[cq + 4 * i] = acc[i] * inv;
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const Params& p, int B,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, bool kPos>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_map(encode, &tq, p.q, D, p.Sq, p.H, B, p.q_s, p.q_h, p.q_b,
                  kBQ16) ||
      !encode_map(encode, &tk, p.k, D, p.Sk, p.KV, B, p.k_s, p.k_h, p.k_b,
                  kBK16) ||
      !encode_map(encode, &tv, p.v, D, p.Sk, p.KV, B, p.v_s, p.v_h, p.v_b,
                  kBK16))
    return (int)cudaErrorInvalidValue;
  Bf16Params bp;
  bp.o = p.o;
  bp.o_b = p.o_b; bp.o_s = p.o_s; bp.o_h = p.o_h;
  bp.H = p.H; bp.KV = p.KV; bp.Sq = p.Sq; bp.Sk = p.Sk;
  bp.causal = p.causal; bp.window = p.window;
  bp.softcap = p.softcap != 0.f;
  bp.score_mul = (bp.softcap ? p.softcap : p.scale) * kLog2e;
  bp.tanh_mul = bp.softcap ? 2.f * kLog2e * p.scale / p.softcap : 0.f;
  bp.pos = p.pos; bp.kb = p.kb; bp.qb = p.qb;
  bp.lse = p.lse; bp.o32 = p.o32;
  const size_t smem = bf16_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, kPos>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * p.H, (p.Sq + kBQ16 - 1) / kBQ16);
  flash_fwd_bf16_kernel<D, kPos><<<grid, kThreads16, smem, stream>>>(
      tq, tk, tv, bp);
  return (int)cudaGetLastError();
}

template <int D, bool kPos>
int launch_d(const Params& p, int B, int bf16, cudaStream_t stream) {
  if (bf16) return launch_bf16<D, kPos>(p, B, stream);
  return launch(flash_fwd_f32_kernel<D, kPos>, kThreads32,
                sizeof(float) * ((kBQ + kBK32) * (D + 1) + kBK32 * D +
                                 kBQ * (kBK32 + 1)),
                p, B, stream);
}

// Fill Params from the C entry points' arguments.
Params make_params(const void* q, const void* k, const void* v, void* o,
                   int H, int KV, int Sq, int Sk, const int64_t* strides,
                   float scale, float softcap, int causal, int window) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_b = strides[0]; p.q_s = strides[1]; p.q_h = strides[2];
  p.k_b = strides[3]; p.k_s = strides[4]; p.k_h = strides[5];
  p.v_b = strides[6]; p.v_s = strides[7]; p.v_h = strides[8];
  p.o_b = strides[9]; p.o_s = strides[10]; p.o_h = strides[11];
  p.H = H; p.KV = KV; p.Sq = Sq; p.Sk = Sk;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window;
  p.pos = nullptr; p.kb = nullptr; p.qb = nullptr;
  p.lse = nullptr; p.o32 = nullptr;
  return p;
}

template <bool kPos>
int launch_any(const Params& p, int B, int D, int bf16, cudaStream_t s) {
  switch (D) {
    case 64: return launch_d<64, kPos>(p, B, bf16, s);
    case 80: return launch_d<80, kPos>(p, B, bf16, s);
    case 128: return launch_d<128, kPos>(p, B, bf16, s);
    case 256: return launch_d<256, kPos>(p, B, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// kPos: the tiles' position bounds (two small launches), then the kernel.
int launch_pos(Params p, int B, int D, int dtype_bf16, const void* positions,
               void* bounds, cudaStream_t s) {
  const int tile = dtype_bf16 ? kBK16 : kBK32;
  const int nkt = (p.Sk + tile - 1) / tile, nqg = (p.Sq + 63) / 64;
  int* kb = (int*)bounds;
  p.pos = (const int*)positions;
  p.kb = kb;
  p.qb = kb + 2 * nkt;
  pos_bounds_kernel<<<(nkt + 127) / 128, 128, 0, s>>>(p.pos, p.Sk, tile, nkt,
                                                      kb);
  pos_bounds_kernel<<<(nqg + 127) / 128, 128, 0, s>>>(p.pos, p.Sq, 64, nqg,
                                                      kb + 2 * nkt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_any<true>(p, B, D, dtype_bf16, s);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  q, k, v and o are [B, S, heads,
// D] views given by their strides (D contiguous); dtype_bf16 selects bf16
// (else fp32).  Each launches on `stream` and returns the CUDA error (0 when
// the launch was accepted); an unsupported head_dim, or a bf16 view that TMA
// cannot map, returns cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, const int64_t* strides, float scale,
    float softcap, int causal, int window, int dtype_bf16, void* stream) {
  const Params p = make_params(q, k, v, o, H, KV, Sq, Sk, strides, scale,
                               softcap, causal, window);
  return launch_any<false>(p, B, D, dtype_bf16, (cudaStream_t)stream);
}

// The same, masking by position: positions is int32 [Sq] (Sq == Sk), one
// vector for queries and keys; bounds is int32 scratch of at least
// 2 * (ceil(Sk / 32) + ceil(Sq / 64)) elements for the tiles' least and
// greatest positions (pos_bounds_kernel, two launches before the kernel).
extern "C" int flash_attention_pos_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, const int64_t* strides, float scale,
    float softcap, int causal, int window, int dtype_bf16,
    const void* positions, void* bounds, void* stream) {
  if (Sq != Sk) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, o, H, KV, Sq, Sk, strides, scale, softcap,
                         causal, window);
  return launch_pos(p, B, D, dtype_bf16, positions, bounds,
                    (cudaStream_t)stream);
}

// The bf16 forward for a call that autograd records: as
// flash_attention_launch (positions null) or flash_attention_pos_launch,
// and also each row's logsumexp of its scores into lse (fp32 [B, H, Sq],
// natural-log units, in the scaled and capped scores' domain) and the
// output before its rounding to bf16 into o32 (fp32 [B, Sq, H, D],
// contiguous), which the backward reads.  fp32 returns
// cudaErrorInvalidValue (its backward computes its own statistics).
extern "C" int flash_attention_stats_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, const int64_t* strides, float scale,
    float softcap, int causal, int window, const void* positions,
    void* bounds, float* lse, float* o32, void* stream) {
  if (lse == nullptr || o32 == nullptr) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, o, H, KV, Sq, Sk, strides, scale, softcap,
                         causal, window);
  p.lse = lse;
  p.o32 = o32;
  const cudaStream_t s = (cudaStream_t)stream;
  if (positions == nullptr) return launch_any<false>(p, B, D, 1, s);
  if (Sq != Sk) return (int)cudaErrorInvalidValue;
  return launch_pos(p, B, D, 1, positions, bounds, s);
}
