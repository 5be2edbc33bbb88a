// Mamba-2 SSD chunked scan for Hopper (sm_90a): the backward on wgmma, bf16.
//
// The JAX package has no backward kernel: it trains mamba2 by autodiff of
// its jnp ssd_chunked (src/repro/models/ssm.py:106), the function its
// Pallas kernel ssd_scan_pallas (src/repro/kernels/ssd_scan/ssd_scan.py:77)
// computes.  This is the gradient of that function for bf16 calls at the
// shapes the forward's wgmma passes tile (P 64, N 128, a chunk that is a
// multiple of 64 up to 256, views TMA can map: mamba2-780m's training);
// ssd_scan.bwd_path in the wrapper decides, and every other call (fp32,
// other widths, unaligned views) runs ssd_scan_bwd.cu's four kernels.  It
// takes what that file takes (dy, dh_final or none, the forward's fp32
// state before each chunk) and writes the same six gradients.
//
// What it computes (c = chunk, j = chunk index, 64-row tiles, acs = the
// cumulative sum of a_t = dt_t A within the chunk, L[t,s] = exp(acs_t -
// acs_s) [s <= t], CB = C B^T, G = dy x^T, tail_s = exp(acs_end - acs_s)
// dt_s, e_t = exp(acs_t), h = h_before_j, dS = the gradient of the state
// after chunk j; ref.py holds each function in plain torch):
//   dx_s  = sum_t CB L dt_s dy_t + tail_s dS B_s + D dy_s        (per head)
//   ddt_s = sum_t CB L G + exp(acs_end - acs_s) <x_s B_s^T, dS> + A da_s
//   dC_t  = sum_s dCB[t,s] B_s + sum_h e_t dy_t h,  dCB = sum_h G L dt_s
//   dB_s  = sum_t dCB[t,s] C_t + sum_h tail_s x_s dS
// with da the reverse cumulative sum of the gradient of acs, and dA, dD
// summed over (b, j).  B and C are shared by the heads, so C B^T is formed
// once per (b, chunk, tile pair) and the head-summed dCB is multiplied by
// B and C once; no per-head [B,S,H,N] partial exists.
//
// Six launches, in order:
//   ssd_bwd_dstate_wgmma, a block per (b, j, h): acs, dt and tail_s to
//     scratch; dh_y = sum_t (e_t dy_t)^T C_t [P, N] by wgmma (both
//     operands MN-major, as the forward's pass 1); C_t h^T by wgmma and,
//     with e_t dy_t, the row term of the acs gradient from e_t dy_t h,
//     inter_t = sum_p (e_t dy_t)[p] (C_t h^T)[p].  dy and C arrive by TMA
//     through a two-stage ring; h_before is converted to bf16 in place.
//   ssd_bwd_state_pass_wgmma, elementwise over (b, h, P N), j from the
//     last: dS_j = g (in bf16, the operand), g <- dh_y_j + exp(acs_end_j)
//     g in fp32; h_before in bf16; <h, dS> in fp32 per warp to scratch.
//   ssd_bwd_pair, a block per (b, j, tile pair t >= s): C B^T once (fp32
//     to scratch, as each thread's accumulator fragment), then for every
//     head G = dy_t x_s^T by wgmma and dCB += G L dt_s in registers, heads
//     in order; dCB to scratch as two bf16 tiles, hi and lo.  x and dy
//     arrive through a 4-stage TMA ring with each head's acs and dt rows
//     (bulk copies).
//   ssd_bwd_shared, a block per (b, j, 64-row tile, dB or dC): dC_t =
//     sum_s dCB B_s + sum_h (e dy)_t h, dB_s = sum_t dCB^T C_t + sum_h
//     (tail x)_s dS, each one accumulator of 64 x 128 over a 4-stage ring
//     of operand pairs (dCB's hi and lo tiles one item each; the H head
//     pairs are one product H P deep); the head rows are scaled in shared
//     memory before their product.
//   ssd_bwd_chunk_wgmma, a block per (b, j, h): for each s-tile, B_s dS^T
//     by wgmma (dx's state term and <x_s B_s^T, dS>), then for each t-tile
//     at or below it G^T = x_s dy_t^T by wgmma, the scores CB^T L dt_s and
//     E = CB L G in registers (C B^T read back from the pair kernel), and
//     dx_s += scores^T dy_t with the scores as wgmma's register operand;
//     E's row and column sums give the acs gradient, whose reverse
//     cumulative sum (one warp) gives ddt, and the chunk's parts of dA and
//     dD.  dy and dS stay resident; B and x come through a 2-stage ring.
//   ssd_bwd_reduce_dad, dA and dD summed over (b, j) in order.
// No atomics: every sum runs in a fixed order, so two launches give the
// same bits.
//
// Roundings.  C B^T and G = dy x^T take bf16 operands exactly.  The other
// products take an fp32 operand, each rounded to bf16 (ref.py's
// operand_dtype path on the "wgmma" path rounds exactly these): e_t dy_t
// (dh_y, dC's head term, inter), h_before (C h^T, dC's head term), dS
// (B dS^T, dB's head term), tail_s x_s (dB's head term) and the scores
// CB L dt_s (dx).  The head-summed dCB (dB, dC) goes as a pair of bf16
// terms, hi = bf16(dCB) and lo = bf16(dCB - hi), each its own product (16
// bits of mantissa): rounded once it put dB's and dC's RMS error at 1.41
// times that of the simple path's rounding (chip_smoke.py's
// simple_rms_err_ratio), where the other roundings add 1% each and the
// scores' 38% to dx.  Operations are not the bound (below), so TF32 would
// cost little, but TF32 wants K-major operands and dS, h and dCB are
// MN-major in two of their products; bf16 keeps each product one wgmma
// form.  Accumulation is fp32 throughout;
// E, Q = <x B^T, dS> and <h, dS> (fp32 h and dS) are not rounded.  exp is
// evaluated only where s <= t (ex2.approx, in log2 units, for L).
//
// What bounds it on an H100 SXM, at mamba2-780m's training shape [1,
// 4096, 48, 64], N 128, c 256: the function moves x, dy, dx (25.2 MB each
// in bf16), h_before (25.2 MB fp32), dt, ddt, B, C, dB and dC: 106 MB,
// 0.032 ms at 3.35 TB/s; its 21.4 GFLOP take 0.022 ms at 989 TFLOP/s, so
// bytes bound it.  These kernels take more products than the function
// needs (G is formed twice, in the pair and the chunk kernels; C h^T once
// more per head for inter): 28.7 GFLOP, 0.029 ms.  Their own traffic is
// the fp32 and bf16 states' round trips (about 100 MB) and C B^T read back
// by every head (123 MB, from L2).  What holds them back is latency: each
// block runs one warpgroup through short wgmma products separated by
// barriers, two or three blocks an SM.
#include <cuda.h>                     // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"                 // TMA, mbarriers, wgmma

namespace {

using bf16 = __nv_bfloat16;

constexpr int kP = 64;                // head dim: one 128-byte bf16 row
constexpr int kN = 128;               // state: two 64-column boxes
constexpr int kTile = 64;             // rows of a TMA box and of a tile
constexpr int kMaxChunk = 256;
constexpr int kThreads = 128;         // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kBoxBytes = kTile * 128;              // 64 x 64 bf16
constexpr uint32_t kRowTile = 2 * kBoxBytes;             // 64 x 128 bf16
constexpr int kHdsParts = kP * kN / 4 / 32;              // warps a state

struct Params {
  const void* dt;
  const void* A;
  const void* D;
  const float* h_before;   // [B,nc,H,P,N] fp32
  const float* dh_final;   // [B,H,P,N] fp32 or null
  bf16* dx;                // [B,S,H,P]
  bf16* ddt;               // [B,S,H]
  void* dA;                // [H], A's dtype
  void* dD;                // [H], D's dtype
  bf16* dB;                // [B,S,N]
  bf16* dC;                // [B,S,N]
  float* dstates;          // [B,nc,H,P,N]: dh_y
  float* chunk_sum;        // [B,H,nc]
  bf16* ds_bf;             // [B,nc,H,P,N] dS in bf16
  bf16* h_bf;              // [B,nc,H,P,N] h_before in bf16
  float* hds;              // [B,nc,H,kHdsParts] parts of <h, dS>
  float* acs;              // [B,nc,H,c]
  float* dts;              // [B,nc,H,c] dt in fp32
  float* tail;             // [B,nc,H,c] exp(acs_end - acs) dt
  float* inter;            // [B,nc,H,c] sum_n C_t (e dy h)_t
  float* cb;               // [B,nc,npair,64*64] C B^T, fragment order
  bf16* dcb;               // [B,nc,npair,2,64,64] sum_h dCB, [t][s]: hi, lo
  float* dA_part;          // [B,H,nc]
  float* dD_part;          // [B,H,nc]
  int64_t dt_b, dt_s, dt_h;           // strides in elements
  int B, S, H, nc, chunk, nT, npair, a_bf16, d_bf16;
};

__device__ __forceinline__ float load_scalar(const void* p, int i,
                                             int bf16_) {
  return bf16_ ? __bfloat162float(((const bf16*)p)[i])
               : ((const float*)p)[i];
}

__device__ __forceinline__ void store_scalar(void* p, int i, float v,
                                             int bf16_) {
  if (bf16_)
    ((bf16*)p)[i] = __float2bfloat16_rn(v);
  else
    ((float*)p)[i] = v;
}

__device__ __forceinline__ int pair_index(int t, int s) {
  return t * (t + 1) / 2 + s;
}

// Byte offset of element (r, col) of a 64-column bf16 box in TMA's 128-byte
// swizzle: row r's 16-byte piece k sits at piece k ^ (r % 8).
__device__ __forceinline__ uint32_t sw(int r, int col) {
  return r * 128 + ((((col >> 3) ^ r) & 7) << 4) + ((col & 7) << 1);
}

// Two bf16 at (r, col), (r, col + 1) of a swizzled box, col even.
__device__ __forceinline__ float2 bf2(const unsigned char* box, int r,
                                      int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(box + sw(r, col)));
}

// Scale each row r of a 64 x 64 swizzled bf16 box by f[r], in place (the
// swizzle permutes 16-byte pieces within a row, not rows); f in fp32.
template <typename F>
__device__ __forceinline__ void scale_rows(unsigned char* box, F f,
                                           int tid) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int piece = tid + kThreads * m, r = piece / 8;
    uint4* ptr = reinterpret_cast<uint4*>(box + r * 128 + piece % 8 * 16);
    uint4 v = *ptr;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
    const float w = f(r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(e[k]);
      e[k] = __floats2bfloat162_rn(x.x * w, x.y * w);
    }
    *ptr = v;
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum over the block's 128 threads, in a fixed order; every thread
// gets it.  `red` holds 4 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
  v = warp_sum(v);
  __syncthreads();                    // earlier readers of red are done
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  return ((red[0] + red[1]) + red[2]) + red[3];
}

// The cumulative log decay of chunk j for (b, h): acs[i] = sum_{k <= i}
// dt_k A and dts[i] = dt_i in shared memory, by a warp-shuffle scan
// (ssd_passes.cu's), every thread of the block together.
__device__ __forceinline__ void chunk_cumsum(const Params& p, int b, int j,
                                             int h, float* acs, float* dts,
                                             float* warp_tot, int tid) {
  const int n = p.chunk;
  const float A = load_scalar(p.A, h, p.a_bf16);
  const bf16* dtg = (const bf16*)p.dt + b * p.dt_b + h * p.dt_h +
                    (int64_t)j * p.chunk * p.dt_s;
  const int w = tid / 32, l = tid % 32, i = 64 * w + 2 * l;
  const float d0 = i < n ? __bfloat162float(dtg[i * p.dt_s]) : 0.f;
  const float d1 = i + 1 < n ? __bfloat162float(dtg[(i + 1) * p.dt_s]) : 0.f;
  const float x0 = d0 * A, x1 = d1 * A;
  float s = x0 + x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, s, o);
    if (l >= o) s += u;
  }
  float prev = __shfl_up_sync(0xffffffffu, s, 1);
  if (l == 0) prev = 0.f;
  if (l == 31) warp_tot[w] = s;
  __syncthreads();
  float base = 0.f;
  for (int k = 0; k < w; ++k) base += warp_tot[k];
  const float r0 = (base + prev) + x0;
  if (i < n) {
    acs[i] = r0;
    dts[i] = d0;
  }
  if (i + 1 < n) {
    acs[i + 1] = r0 + x1;
    dts[i + 1] = d1;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// dh_y, inter and the chunk's decay arrays
// ---------------------------------------------------------------------------

constexpr uint32_t kDStage = kBoxBytes + kRowTile;       // dy_t, C_t
constexpr size_t kDStateSmem = 1024 + 2 * kDStage + kRowTile +
                               4 * (3 * kMaxChunk + 4) + 8 * 2;

__global__ void __launch_bounds__(kThreads)
ssd_bwd_dstate_wgmma(const __grid_constant__ CUtensorMap tm_dy,
                     const __grid_constant__ CUtensorMap tm_c,
                     const Params p) {
  const int c = p.chunk, nq = p.nT, tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u; // stage st at + st kDStage
  unsigned char* gring = smem_raw + (ring - raw);
  const uint32_t sH = ring + 2 * kDStage;      // h in bf16, two boxes
  unsigned char* gH = gring + 2 * kDStage;
  float* acs = reinterpret_cast<float*>(gH + kRowTile);
  float* dts = acs + kMaxChunk;
  float* ev = dts + kMaxChunk;                 // exp(acs)
  float* warp_tot = ev + kMaxChunk;
  const uint32_t full = sH + kRowTile + 4 * (3 * kMaxChunk + 4);

  int blk = blockIdx.x;
  const int h = blk % p.H;
  blk /= p.H;
  const int j = blk % p.nc, b = blk / p.nc;
  const int s0 = j * c;
  const int64_t row = ((int64_t)b * p.nc + j) * p.H + h;   // (b, j, h)

  auto issue = [&](int q, int st) {
    const uint32_t dst = ring + st * kDStage, fb = full + 8 * st;
    mbar_expect_tx(fb, kDStage);
    tma_load(dst, &tm_dy, fb, 0, s0 + q * kTile, h, b);
    tma_load(dst + kBoxBytes, &tm_c, fb, 0, s0 + q * kTile, 0, b);
    tma_load(dst + 2 * kBoxBytes, &tm_c, fb, 64, s0 + q * kTile, 0, b);
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    issue(0, 0);
    if (nq > 1) issue(1, 1);
  }
  __syncwarp();

  chunk_cumsum(p, b, j, h, acs, dts, warp_tot, tid);
  const float a_end = acs[c - 1];
  for (int i = tid; i < c; i += kThreads) {
    ev[i] = expf(acs[i]);
    p.acs[row * c + i] = acs[i];
    p.dts[row * c + i] = dts[i];
    p.tail[row * c + i] = expf(a_end - acs[i]) * dts[i];
  }
  if (tid == 0) p.chunk_sum[((int64_t)b * p.H + h) * p.nc + j] = a_end;
  // h_before (fp32) into shared memory as bf16 in the 128-byte swizzle
  const float4* hg = reinterpret_cast<const float4*>(p.h_before +
                                                     row * kP * kN);
  for (int i = tid; i < kP * kN / 4; i += kThreads) {
    const float4 v = hg[i];
    const int r = i / (kN / 4), col = i % (kN / 4) * 4;
    uint2 w;
    w.x = pack_bf16(v.x, v.y);
    w.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(gH + (col / 64) * kBoxBytes +
                              sw(r, col % 64)) = w;
  }
  fence_proxy_async();
  __syncthreads();

  const int warp = tid / 32, g = tid % 32 / 4, tq = tid % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  float dh[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dh[i] = 0.f;
  for (int q = 0; q < nq; ++q) {
    const int st = q & 1;
    const uint32_t stage = ring + st * kDStage;
    unsigned char* gst = gring + st * kDStage;
    mbar_wait(full + 8 * st, (q >> 1) & 1);
    scale_rows(gst, [&](int r) { return ev[q * kTile + r]; }, tid);
    fence_proxy_async();
    __syncthreads();
    // dh_y += (e dy)^T C (both MN-major); C h^T (both K-major)
    float ch[32];
    fence_regs(dh);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_ss_tt(dh, sw128_desc(stage + kk * 2048, kBoxBytes, 1024),
                  sw128_desc(stage + kBoxBytes + kk * 2048, kBoxBytes, 1024));
#pragma unroll
    for (int kd = 0; kd < kN; kd += 16) {
      const uint32_t off = (kd / 64) * kBoxBytes + (kd % 64) * 2;
      wgmma_ss(ch, sw128_desc(stage + kBoxBytes + off, 16, 1024),
               sw128_desc(sH + off, 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dh);
    fence_regs(ch);
    // inter_t = sum_p (e dy)[t,p] (C h^T)[t,p] for rows r0, r1
    float i0 = 0.f, i1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < kP / 8; ++jj) {
      const int col = 8 * jj + 2 * tq;
      const float2 a = bf2(gst, r0, col), a1 = bf2(gst, r1, col);
      i0 = fmaf(ch[4 * jj], a.x, fmaf(ch[4 * jj + 1], a.y, i0));
      i1 = fmaf(ch[4 * jj + 2], a1.x, fmaf(ch[4 * jj + 3], a1.y, i1));
    }
    i0 = quad_sum(i0);
    i1 = quad_sum(i1);
    if (tq == 0) {
      p.inter[row * c + q * kTile + r0] = i0;
      p.inter[row * c + q * kTile + r1] = i1;
    }
    __syncthreads();                             // stage st is free
    if (tid == 0 && q + 2 < nq) issue(q + 2, st);
    __syncwarp();
  }

  // dh[p][n]: rows 16 warp + g (+ 8), columns 8 jj + 2 tq (+ 1)
  float* out = p.dstates + row * kP * kN + r0 * kN + 2 * tq;
#pragma unroll
  for (int jj = 0; jj < kN / 8; ++jj) {
    *reinterpret_cast<float2*>(out + 8 * jj) =
        make_float2(dh[4 * jj], dh[4 * jj + 1]);
    *reinterpret_cast<float2*>(out + 8 * kN + 8 * jj) =
        make_float2(dh[4 * jj + 2], dh[4 * jj + 3]);
  }
}

// ---------------------------------------------------------------------------
// the state's gradient from the last chunk to the first
// ---------------------------------------------------------------------------

constexpr int kPassThreads = 256;
constexpr int kAhead = 8;             // chunks whose loads are in flight

__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass_wgmma(const float4* __restrict__ dstates,
                         const float* __restrict__ chunk_sum,
                         const float4* __restrict__ dh_final,
                         const float4* __restrict__ h_before,
                         uint2* __restrict__ ds_bf, uint2* __restrict__ h_bf,
                         float* __restrict__ hds, int H, int nc,
                         int total) {
  constexpr int kPN4 = kP * kN / 4;   // float4s of one (b, j, h) state
  const int i = blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= total) return;             // total is a multiple of the block
  const int bh = i / kPN4, e = i % kPN4;
  const int b = bh / H, h = bh % H;
  const float* cs = chunk_sum + (int64_t)bh * nc;
  float4 gv = dh_final ? dh_final[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = nc - 1; j0 >= 0; j0 -= kAhead) {
    float4 d[kAhead], hv[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (j0 - k >= 0) {
        const int64_t at = (((int64_t)b * nc + j0 - k) * H + h) * kPN4 + e;
        d[k] = dstates[at];
        hv[k] = h_before[at];
        dec[k] = expf(cs[j0 - k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (j0 - k >= 0) {
        const int64_t st = ((int64_t)b * nc + j0 - k) * H + h;
        const int64_t at = st * kPN4 + e;
        uint2 w;
        w.x = pack_bf16(gv.x, gv.y);
        w.y = pack_bf16(gv.z, gv.w);
        ds_bf[at] = w;
        w.x = pack_bf16(hv[k].x, hv[k].y);
        w.y = pack_bf16(hv[k].z, hv[k].w);
        h_bf[at] = w;
        const float dot = warp_sum(
            fmaf(hv[k].x, gv.x, fmaf(hv[k].y, gv.y,
                 fmaf(hv[k].z, gv.z, hv[k].w * gv.w))));
        if (e % 32 == 0) hds[st * kHdsParts + e / 32] = dot;
        gv.x = fmaf(dec[k], gv.x, d[k].x);
        gv.y = fmaf(dec[k], gv.y, d[k].y);
        gv.z = fmaf(dec[k], gv.z, d[k].z);
        gv.w = fmaf(dec[k], gv.w, d[k].w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C B^T and the head-summed dCB of each tile pair
// ---------------------------------------------------------------------------

constexpr int kPairStages = 4;        // two a warpgroup
constexpr uint32_t kPairStage = 2 * kBoxBytes + 1024;    // x_s, dy_t, rows
constexpr uint32_t kPairRows = 3 * kTile * 4;            // acs_t, acs_s, dt_s
constexpr size_t kPairSmem = 1024 + 2 * kRowTile + kPairStages * kPairStage +
                             8 * (1 + kPairStages);

__global__ void __launch_bounds__(2 * kThreads)
ssd_bwd_pair(const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ CUtensorMap tm_dy,
             const __grid_constant__ CUtensorMap tm_b,
             const __grid_constant__ CUtensorMap tm_c, const Params p) {
  const int c = p.chunk;
  // the warpgroup, warp-uniform so that ptxas sees uniform control
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / kThreads, 0);
  const int tid = threadIdx.x % kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sB = (raw + 1023) & ~1023u;   // B_s [64][128]
  const uint32_t sC = sB + kRowTile;           // C_t [64][128]
  const uint32_t ring = sC + kRowTile;         // stage k at + k kPairStage
  unsigned char* gring = smem_raw + (ring - raw);
  const uint32_t bar_bc = ring + kPairStages * kPairStage;
  const uint32_t full = bar_bc + 8;

  int blk = blockIdx.x;
  const int pr = blk % p.npair;
  blk /= p.npair;
  const int j = blk % p.nc, b = blk / p.nc;
  int tt = 0;
  while (pair_index(tt + 1, 0) <= pr) ++tt;
  const int u = pr - pair_index(tt, 0);        // s-tile u <= t-tile tt
  const int s0 = j * c;
  const int64_t bj = (int64_t)b * p.nc + j;

  // head hh lands in stage hh % 4 and belongs to warpgroup hh % 2
  auto issue = [&](int hh, int st) {
    const uint32_t dst = ring + st * kPairStage, fb = full + 8 * st;
    const int64_t rows = (bj * p.H + hh) * c;
    mbar_expect_tx(fb, 2 * kBoxBytes + kPairRows);
    tma_load(dst, &tm_x, fb, 0, s0 + u * kTile, hh, b);
    tma_load(dst + kBoxBytes, &tm_dy, fb, 0, s0 + tt * kTile, hh, b);
    bulk_load(dst + 2 * kBoxBytes, p.acs + rows + tt * kTile, 256, fb);
    bulk_load(dst + 2 * kBoxBytes + 256, p.acs + rows + u * kTile, 256, fb);
    bulk_load(dst + 2 * kBoxBytes + 512, p.dts + rows + u * kTile, 256, fb);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_bc, 1);
    for (int s = 0; s < kPairStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_bc, 2 * kRowTile);
    tma_load(sB, &tm_b, bar_bc, 0, s0 + u * kTile, 0, b);
    tma_load(sB + kBoxBytes, &tm_b, bar_bc, 64, s0 + u * kTile, 0, b);
    tma_load(sC, &tm_c, bar_bc, 0, s0 + tt * kTile, 0, b);
    tma_load(sC + kBoxBytes, &tm_c, bar_bc, 64, s0 + tt * kTile, 0, b);
    for (int hh = 0; hh < kPairStages && hh < p.H; ++hh) issue(hh, hh);
  }
  __syncwarp();

  // C B^T as CB^T[s][t] = B_s . C_t, once for the pair (warpgroup 0); each
  // thread's accumulator fragment goes out as 8 float4s, read back in the
  // same layout by the chunk kernel
  if (wg == 0) {
    mbar_wait(bar_bc, 0);
    float cbt[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < kN; kd += 16) {
      const uint32_t off = (kd / 64) * kBoxBytes + (kd % 64) * 2;
      wgmma_ss(cbt, sw128_desc(sB + off, 16, 1024),
               sw128_desc(sC + off, 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(cbt);
    float4* out = reinterpret_cast<float4*>(p.cb + (bj * p.npair + pr) *
                                            kTile * kTile);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      out[q * kThreads + tid] = make_float4(cbt[4 * q], cbt[4 * q + 1],
                                            cbt[4 * q + 2], cbt[4 * q + 3]);
  }

  const int warp = tid / 32, g = tid % 32 / 4, tq = tid % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;   // t rows of the tile
  float dcb[32];                               // this warpgroup's heads
#pragma unroll
  for (int i = 0; i < 32; ++i) dcb[i] = 0.f;
  for (int hh = wg; hh < p.H; hh += 2) {
    const int st = hh % kPairStages;
    const uint32_t stage = ring + st * kPairStage;
    mbar_wait(full + 8 * st, (hh / kPairStages) & 1);
    // G[t][s] = dy_t . x_s (both K-major)
    float gv[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk)
      wgmma_ss(gv, sw128_desc(stage + kBoxBytes + kk * 32, 16, 1024),
               sw128_desc(stage + kk * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(gv);
    const float* at = reinterpret_cast<const float*>(gring + st * kPairStage +
                                                     2 * kBoxBytes);
    const float* as = at + kTile;
    const float* ds = at + 2 * kTile;
    const float a0 = at[r0], a1 = at[r1];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i & 2) ? r1 : r0;
      const int cc = 8 * (i / 4) + 2 * tq + (i & 1);
      const bool in = tt > u || cc <= r;
      const float l = in ? ex2((((i & 2) ? a1 : a0) - as[cc]) * kLog2e) : 0.f;
      dcb[i] = fmaf(gv[i], l * ds[cc], dcb[i]);
    }
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kThreads)
                 : "memory");                  // stage st is free
    if (tid == 0 && hh + kPairStages < p.H) issue(hh + kPairStages, st);
    __syncwarp();
  }

  // dCB = (even heads) + (odd heads), then hi + lo, each bf16
  __syncthreads();                             // every stage is consumed
  float4* xch = reinterpret_cast<float4*>(gring);
  if (wg == 1) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      xch[q * kThreads + tid] = make_float4(dcb[4 * q], dcb[4 * q + 1],
                                            dcb[4 * q + 2], dcb[4 * q + 3]);
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = xch[q * kThreads + tid];
    dcb[4 * q] += v.x;
    dcb[4 * q + 1] += v.y;
    dcb[4 * q + 2] += v.z;
    dcb[4 * q + 3] += v.w;
  }
  bf16* hi = p.dcb + (bj * p.npair + pr) * 2 * kTile * kTile;
  bf16* lo = hi + kTile * kTile;
#pragma unroll
  for (int jj = 0; jj < kTile / 8; ++jj) {
    const int col = 8 * jj + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float v0 = dcb[4 * jj + 2 * half], v1 = dcb[4 * jj + 2 * half + 1];
      const uint32_t h2 = pack_bf16(v0, v1);
      const float2 back = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&h2));
      const int at = (half ? r1 : r0) * kTile + col;
      *reinterpret_cast<uint32_t*>(hi + at) = h2;
      *reinterpret_cast<uint32_t*>(lo + at) =
          pack_bf16(v0 - back.x, v1 - back.y);
    }
  }
}

// ---------------------------------------------------------------------------
// dB and dC, each summed over the heads
// ---------------------------------------------------------------------------

constexpr int kSharedStages = 4;      // two a warpgroup
constexpr uint32_t kSharedStage = kBoxBytes + kRowTile + 1024;  // A, B, rows
constexpr size_t kSharedSmem = 1024 + kSharedStages * kSharedStage +
                               8 * kSharedStages;

__global__ void __launch_bounds__(2 * kThreads)
ssd_bwd_shared(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_dy,
               const __grid_constant__ CUtensorMap tm_b,
               const __grid_constant__ CUtensorMap tm_c,
               const __grid_constant__ CUtensorMap tm_dsb,
               const __grid_constant__ CUtensorMap tm_hb,
               const __grid_constant__ CUtensorMap tm_dcb, const Params p) {
  const int c = p.chunk;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / kThreads, 0);
  const int tid = threadIdx.x % kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* gring = smem_raw + (ring - raw);
  const uint32_t full = ring + kSharedStages * kSharedStage;

  int blk = blockIdx.x;
  const int role = blk & 1;                    // 0: dC of t-tile k, 1: dB
  blk >>= 1;
  const int k = blk % p.nT;
  blk /= p.nT;
  const int j = blk % p.nc, b = blk / p.nc;
  const int s0 = j * c;
  const int64_t bj = (int64_t)b * p.nc + j;
  // items: dCB's hi and lo tiles of each tile pair (dC: (k, u) for u <= k;
  // dB: (t, k) for t >= k), then one per head; item it lands in stage
  // it % 4 and belongs to warpgroup it % 2
  const int n_pairs = 2 * (role ? p.nT - k : k + 1);
  const int n_items = n_pairs + p.H;

  auto issue = [&](int item, int st) {
    const uint32_t dst = ring + st * kSharedStage, fb = full + 8 * st;
    if (item < n_pairs) {
      const int other = role ? k + item / 2 : item / 2;
      const int pr = role ? pair_index(other, k) : pair_index(k, other);
      const CUtensorMap* mb = role ? &tm_c : &tm_b;
      mbar_expect_tx(fb, kBoxBytes + kRowTile);
      tma_load(dst, &tm_dcb, fb, 0,
               (int)(((bj * p.npair + pr) * 2 + item % 2) * kTile), 0, 0);
      tma_load(dst + kBoxBytes, mb, fb, 0, s0 + other * kTile, 0, b);
      tma_load(dst + 2 * kBoxBytes, mb, fb, 64, s0 + other * kTile, 0, b);
    } else {
      const int hh = item - n_pairs;
      const int64_t st_row = bj * p.H + hh;
      const CUtensorMap* mb = role ? &tm_dsb : &tm_hb;
      mbar_expect_tx(fb, kBoxBytes + kRowTile + 256);
      tma_load(dst, role ? &tm_x : &tm_dy, fb, 0, s0 + k * kTile, hh, b);
      tma_load(dst + kBoxBytes, mb, fb, 0, (int)(st_row * kP), 0, 0);
      tma_load(dst + 2 * kBoxBytes, mb, fb, 64, (int)(st_row * kP), 0, 0);
      bulk_load(dst + kBoxBytes + kRowTile,
                (role ? p.tail : p.acs) + st_row * c + k * kTile, 256, fb);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSharedStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int it = 0; it < kSharedStages && it < n_items; ++it) issue(it, it);
  __syncwarp();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = wg; it < n_items; it += 2) {
    const int st = it % kSharedStages;
    const uint32_t stage = ring + st * kSharedStage;
    unsigned char* gst = gring + st * kSharedStage;
    mbar_wait(full + 8 * st, (it / kSharedStages) & 1);
    if (it >= n_pairs) {
      // the head's rows times e_t = exp(acs_t) (dy) or tail_s (x), bf16
      const float* f = reinterpret_cast<const float*>(gst + kBoxBytes +
                                                      kRowTile);
      if (role)
        scale_rows(gst, [&](int r) { return f[r]; }, tid);
      else
        scale_rows(gst, [&](int r) { return expf(f[r]); }, tid);
      fence_proxy_async();
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kThreads)
                   : "memory");
    }
    if (role && it < n_pairs) {
      // dB_s += dCB[t][s]^T C_t: A MN-major, B MN-major
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_ss_tt(acc, sw128_desc(stage + kk * 2048, kBoxBytes, 1024),
                    sw128_desc(stage + kBoxBytes + kk * 2048, kBoxBytes,
                               1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    } else {
      // A K-major (dCB[t][s] for dC, the scaled rows), B MN-major
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_ss_nt(acc, sw128_desc(stage + kk * 32, 16, 1024),
                    sw128_desc(stage + kBoxBytes + kk * 2048, kBoxBytes,
                               1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kThreads)
                 : "memory");                  // stage st is free
    if (tid == 0 && it + kSharedStages < n_items)
      issue(it + kSharedStages, st);
    __syncwarp();
  }

  // the sum is (even items) + (odd items)
  __syncthreads();                             // every stage is consumed
  float4* xch = reinterpret_cast<float4*>(gring);
  if (wg == 1) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
      xch[q * kThreads + tid] = make_float4(acc[4 * q], acc[4 * q + 1],
                                            acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float4 v = xch[q * kThreads + tid];
    acc[4 * q] += v.x;
    acc[4 * q + 1] += v.y;
    acc[4 * q + 2] += v.z;
    acc[4 * q + 3] += v.w;
  }
  const int warp = tid / 32, g = tid % 32 / 4, tq = tid % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  bf16* out = (role ? p.dB : p.dC) + ((int64_t)b * p.S + s0 + k * kTile) * kN;
#pragma unroll
  for (int jj = 0; jj < kN / 8; ++jj) {
    const int col = 8 * jj + 2 * tq;
    *reinterpret_cast<uint32_t*>(out + r0 * kN + col) =
        pack_bf16(acc[4 * jj], acc[4 * jj + 1]);
    *reinterpret_cast<uint32_t*>(out + r1 * kN + col) =
        pack_bf16(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// ---------------------------------------------------------------------------
// dx, ddt and the chunk's parts of dA and dD, per head
// ---------------------------------------------------------------------------

constexpr uint32_t kChunkStage = kRowTile + kBoxBytes;   // B_s, x_s
constexpr int kChunkFloats = 11 * kMaxChunk + 16;
constexpr size_t kChunkSmem = 1024 + 4 * kBoxBytes + kRowTile +
                              2 * kChunkStage + 4 * kChunkFloats + 8 * 7;

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_wgmma(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_dy,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_dsb,
                    const Params p) {
  const int c = p.chunk, nT = p.nT, tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sDy = (raw + 1023) & ~1023u;  // dy tile q at + q kBoxBytes
  unsigned char* gDy = smem_raw + (sDy - raw);
  const uint32_t sDS = sDy + 4 * kBoxBytes;    // dS in bf16, two boxes
  const uint32_t ring = sDS + kRowTile;        // stage k at + k kChunkStage
  unsigned char* gring = gDy + (ring - sDy);
  float* acs = reinterpret_cast<float*>(gring + 2 * kChunkStage);
  float* dts = acs + kMaxChunk;
  float* tail = dts + kMaxChunk;
  float* inter = tail + kMaxChunk;               // these four by bulk copy
  float* colE = inter + kMaxChunk;             // sum_t E[t][s]
  float* rowM = colE + kMaxChunk;              // dacs, then da
  float* Q = rowM + kMaxChunk;                 // <x_s B_s^T, dS>
  float* wrow = Q + kMaxChunk;                 // [4][c]: each warp's part
                                               // of sum_s E[t][s] dt_s
  float* red = wrow + 4 * kMaxChunk;           // [16]
  const uint32_t bar_s = ring + 2 * kChunkStage + 4 * kChunkFloats;
  const uint32_t bar_dy = bar_s + 8;           // tile q at + 8 q
  const uint32_t full = bar_dy + 32;           // stage k at + 8 k

  int blk = blockIdx.x;
  const int h = blk % p.H;
  blk /= p.H;
  const int j = blk % p.nc, b = blk / p.nc;
  const int s0 = j * c;
  const int64_t bj = (int64_t)b * p.nc + j, row = bj * p.H + h;

  auto issue = [&](int u, int st) {
    const uint32_t dst = ring + st * kChunkStage, fb = full + 8 * st;
    mbar_expect_tx(fb, kChunkStage);
    tma_load(dst, &tm_b, fb, 0, s0 + u * kTile, 0, b);
    tma_load(dst + kBoxBytes, &tm_b, fb, 64, s0 + u * kTile, 0, b);
    tma_load(dst + kRowTile, &tm_x, fb, 0, s0 + u * kTile, h, b);
  };
  if (tid == 0) {
    mbar_init(bar_s, 1);
    for (int q = 0; q < 4; ++q) mbar_init(bar_dy + 8 * q, 1);
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_s, kRowTile + 16 * c);
    tma_load(sDS, &tm_dsb, bar_s, 0, (int)(row * kP), 0, 0);
    tma_load(sDS + kBoxBytes, &tm_dsb, bar_s, 64, (int)(row * kP), 0, 0);
    const uint32_t sacs = ring + 2 * kChunkStage;
    bulk_load(sacs, p.acs + row * c, 4 * c, bar_s);
    bulk_load(sacs + 4 * kMaxChunk, p.dts + row * c, 4 * c, bar_s);
    bulk_load(sacs + 8 * kMaxChunk, p.tail + row * c, 4 * c, bar_s);
    bulk_load(sacs + 12 * kMaxChunk, p.inter + row * c, 4 * c, bar_s);
    for (int q = 0; q < nT; ++q) {
      mbar_expect_tx(bar_dy + 8 * q, kBoxBytes);
      tma_load(sDy + q * kBoxBytes, &tm_dy, bar_dy + 8 * q, 0,
               s0 + q * kTile, h, b);
    }
    for (int u = 0; u < 2 && u < nT; ++u) issue(u, u);
  }
  for (int i = tid; i < 4 * kMaxChunk; i += kThreads) wrow[i] = 0.f;
  // <h, dS> from the state pass's warp parts, in order
  if (tid < kHdsParts) {
    const float v = warp_sum(p.hds[row * kHdsParts + tid]);
    if (tid % 32 == 0) red[8 + tid / 32] = v;
  }
  const float A = load_scalar(p.A, h, p.a_bf16);
  const float Dh = load_scalar(p.D, h, p.d_bf16);
  __syncthreads();
  mbar_wait(bar_s, 0);

  const int warp = tid / 32, g = tid % 32 / 4, tq = tid % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;   // s rows of the tile
  float dd = 0.f;                              // sum_t dy_t . x_t
  for (int u = 0; u < nT; ++u) {
    const int st = u & 1;
    const uint32_t sBu = ring + st * kChunkStage, sXu = sBu + kRowTile;
    const unsigned char* gX = gring + st * kChunkStage + kRowTile;
    const unsigned char* gDyU = gDy + u * kBoxBytes;
    mbar_wait(full + 8 * st, (u >> 1) & 1);
    mbar_wait(bar_dy + 8 * u, 0);
    // BdS[s][p] = B_s . dS_p (both K-major)
    float bd[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < kN; kd += 16) {
      const uint32_t off = (kd / 64) * kBoxBytes + (kd % 64) * 2;
      wgmma_ss(bd, sw128_desc(sBu + off, 16, 1024),
               sw128_desc(sDS + off, 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(bd);
    // Q_s = x_s . BdS_s; dx_s = tail_s BdS_s + D dy_s
    const int sa = u * kTile + r0, sb = u * kTile + r1;
    const float ta = tail[sa], tb = tail[sb];
    float dx[32], q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < kP / 8; ++jj) {
      const int col = 8 * jj + 2 * tq;
      const float2 xa = bf2(gX, r0, col), xb = bf2(gX, r1, col);
      const float2 ya = bf2(gDyU, r0, col), yb = bf2(gDyU, r1, col);
      q0 = fmaf(bd[4 * jj], xa.x, fmaf(bd[4 * jj + 1], xa.y, q0));
      q1 = fmaf(bd[4 * jj + 2], xb.x, fmaf(bd[4 * jj + 3], xb.y, q1));
      dx[4 * jj] = fmaf(ta, bd[4 * jj], Dh * ya.x);
      dx[4 * jj + 1] = fmaf(ta, bd[4 * jj + 1], Dh * ya.y);
      dx[4 * jj + 2] = fmaf(tb, bd[4 * jj + 2], Dh * yb.x);
      dx[4 * jj + 3] = fmaf(tb, bd[4 * jj + 3], Dh * yb.y);
    }
    q0 = quad_sum(q0);
    q1 = quad_sum(q1);
    if (tq == 0) {
      Q[sa] = q0;
      Q[sb] = q1;
    }
    const float as0 = acs[sa], as1 = acs[sb], ds0 = dts[sa], ds1 = dts[sb];
    float ce0 = 0.f, ce1 = 0.f;
    for (int tt = u; tt < nT; ++tt) {
      mbar_wait(bar_dy + 8 * tt, 0);
      const uint32_t sDyT = sDy + tt * kBoxBytes;
      // C B^T of the pair from the pair kernel, in its fragment layout
      const float4* cbg = reinterpret_cast<const float4*>(
          p.cb + (bj * p.npair + pair_index(tt, u)) * kTile * kTile);
      float sc[32];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = cbg[q * kThreads + tid];
        sc[4 * q] = v.x;
        sc[4 * q + 1] = v.y;
        sc[4 * q + 2] = v.z;
        sc[4 * q + 3] = v.w;
      }
      // G^T[s][t] = x_s . dy_t (both K-major)
      float gt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk)
        wgmma_ss(gt, sw128_desc(sXu + kk * 32, 16, 1024),
                 sw128_desc(sDyT + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(gt);
      // scores CB L dt_s (into sc), E = CB L G; E's sums over t (colE, by
      // row s) and E dt_s's over s (by column t, cm)
      float cm[16];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = i & 2;
        const int r = hi ? r1 : r0;
        const int cc = 8 * (i / 4) + 2 * tq + (i & 1);
        const bool in = tt > u || cc >= r;
        const float l = in ? ex2((acs[tt * kTile + cc] - (hi ? as1 : as0)) *
                                 kLog2e)
                           : 0.f;
        const float cbl = sc[i] * l, e = cbl * gt[i], d = hi ? ds1 : ds0;
        sc[i] = cbl * d;
        if (hi) {
          ce1 += e;
          cm[(i / 4) * 2 + (i & 1)] = fmaf(e, d, cm[(i / 4) * 2 + (i & 1)]);
        } else {
          ce0 += e;
          cm[(i / 4) * 2 + (i & 1)] = e * d;
        }
        if (tt == u && cc == r) dd += gt[i];
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        float v = cm[m];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        cm[m] = v;
      }
      if (g == 0) {                            // one lane a column
        float* w = wrow + warp * kMaxChunk + tt * kTile + 2 * tq;
#pragma unroll
        for (int m = 0; m < 16; ++m) w[8 * (m / 2) + (m & 1)] += cm[m];
      }
      // dx_s += scores^T dy_t: scores (bf16) from registers, dy MN-major
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        a[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        a[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        a[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      fence_regs(dx);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dx, a[kk], sw128_desc(sDyT + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dx);
    }
    ce0 = quad_sum(ce0);
    ce1 = quad_sum(ce1);
    if (tq == 0) {
      colE[sa] = ce0;
      colE[sb] = ce1;
    }
    bf16* dxg = p.dx + (((int64_t)b * p.S + s0 + u * kTile) * p.H + h) * kP;
    const int64_t rs = (int64_t)p.H * kP;
#pragma unroll
    for (int jj = 0; jj < kP / 8; ++jj) {
      const int col = 8 * jj + 2 * tq;
      *reinterpret_cast<uint32_t*>(dxg + r0 * rs + col) =
          pack_bf16(dx[4 * jj], dx[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(dxg + r1 * rs + col) =
          pack_bf16(dx[4 * jj + 2], dx[4 * jj + 3]);
    }
    __syncthreads();                           // stage st is free
    if (tid == 0 && u + 2 < nT) issue(u + 2, st);
    __syncwarp();
  }

  // the gradient of acs: sum_s E dt_s (the warps' parts in order) - dt
  // colE - tail Q + inter, and at the last step the decay of h into the
  // next chunk, sum_s tail_s Q_s + exp(acs_end) <h, dS>
  float tqs = 0.f;
  for (int i = tid; i < c; i += kThreads) {
    const float em = ((wrow[i] + wrow[kMaxChunk + i]) +
                      wrow[2 * kMaxChunk + i]) + wrow[3 * kMaxChunk + i];
    rowM[i] = em - dts[i] * colE[i] - tail[i] * Q[i] + inter[i];
    tqs = fmaf(tail[i], Q[i], tqs);
  }
  tqs = block_sum(tqs, red, tid);
  if (tid == 0) rowM[c - 1] += tqs + expf(acs[c - 1]) * (red[8] + red[9]);
  __syncthreads();
  // da: the reverse cumulative sum, one warp, c / 32 steps a lane
  if (warp == 0) {
    const int per = c / 32, base = tid * per;
    float tot = 0.f;
    for (int k = 0; k < per; ++k) tot += rowM[base + k];
    float v = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_down_sync(0xffffffffu, v, o);
      if (tid + o < 32) v += n;
    }
    float run = v - tot;
    for (int k = per - 1; k >= 0; --k) {
      run += rowM[base + k];
      rowM[base + k] = run;
    }
  }
  __syncthreads();
  const float a_end = acs[c - 1];
  bf16* ddtg = p.ddt + ((int64_t)b * p.S + s0) * p.H + h;
  float dap = 0.f;
  for (int i = tid; i < c; i += kThreads) {
    const float da = rowM[i];
    ddtg[(int64_t)i * p.H] = __float2bfloat16_rn(
        colE[i] + expf(a_end - acs[i]) * Q[i] + A * da);
    dap = fmaf(dts[i], da, dap);
  }
  dap = block_sum(dap, red, tid);
  dd = block_sum(dd, red, tid);
  if (tid == 0) {
    p.dA_part[((int64_t)b * p.H + h) * p.nc + j] = dap;
    p.dD_part[((int64_t)b * p.H + h) * p.nc + j] = dd;
  }
}

// ---------------------------------------------------------------------------
// dA and dD over (b, j)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_dad(const Params p) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= p.H) return;
  float dA = 0.f, dD = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int j = 0; j < p.nc; ++j) {
      const int64_t part = ((int64_t)b * p.H + h) * p.nc + j;
      dA += p.dA_part[part];
      dD += p.dD_part[part];
    }
  store_scalar(p.dA, h, dA, p.a_bf16);
  store_scalar(p.dD, h, dD, p.d_bf16);
}

// The buffers of one launch, in the order of ssd_scan_bwd_wgmma_launch's
// `bufs` (ssd_scan.BWD_WGMMA_BUFFERS).
enum Buf {
  kX, kDt, kA, kB, kC, kD, kDy, kHBefore, kDhFinal,       // inputs
  kDx, kDdt, kDA, kDB, kDC, kDD,                          // outputs
  kDStates, kChunkSum, kDsBf, kHBf, kHds, kAcs, kDts, kTail, kInter,
  kCb, kDcb, kDAPart, kDDPart,                            // scratch
  kNumBufs
};

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Plain C entry point, loaded with ctypes: the six launches on `stream`;
// returns the CUDA error (0 when every launch was accepted).  `bufs` holds
// 28 device pointers (Buf's order): x [B,S,H,P], dt [B,S,H], A [H], B and
// C [B,S,N], D [H], dy [B,S,H,P] (x, dt, B, C and dy bf16, by their
// strides; x, B, C and dy as TMA maps them), h_before fp32 [B,nc,H,P,N],
// dh_final fp32 [B,H,P,N] or null; the outputs dx [B,S,H,P], ddt [B,S,H],
// dB and dC [B,S,N] (bf16, contiguous), dA and dD [H] (A's and D's
// dtypes); the scratch of ssd_scan.bwd_scratch_shapes(..., "wgmma"), each
// contiguous.  `strides` is 13 int64 as for ssd_scan_bwd_launch.  Shapes
// this path does not tile (P != 64, N != 128, a chunk that is not a
// multiple of 64 up to 256, S % chunk != 0, an empty axis) and views TMA
// cannot map return cudaErrorInvalidValue.
extern "C" int ssd_scan_bwd_wgmma_launch(void* const* bufs, int B, int S,
                                         int H, int P, int N, int chunk,
                                         const int64_t* strides, int a_bf16,
                                         int d_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P != kP || N != kN || chunk <= 0 ||
      chunk % kTile || chunk > kMaxChunk || S % chunk)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  Params p;
  p.dt = bufs[kDt]; p.A = bufs[kA]; p.D = bufs[kD];
  p.h_before = (const float*)bufs[kHBefore];
  p.dh_final = (const float*)bufs[kDhFinal];
  p.dx = (bf16*)bufs[kDx]; p.ddt = (bf16*)bufs[kDdt];
  p.dA = bufs[kDA]; p.dD = bufs[kDD];
  p.dB = (bf16*)bufs[kDB]; p.dC = (bf16*)bufs[kDC];
  p.dstates = (float*)bufs[kDStates];
  p.chunk_sum = (float*)bufs[kChunkSum];
  p.ds_bf = (bf16*)bufs[kDsBf]; p.h_bf = (bf16*)bufs[kHBf];
  p.hds = (float*)bufs[kHds];
  p.acs = (float*)bufs[kAcs]; p.dts = (float*)bufs[kDts];
  p.tail = (float*)bufs[kTail]; p.inter = (float*)bufs[kInter];
  p.cb = (float*)bufs[kCb]; p.dcb = (bf16*)bufs[kDcb];
  p.dA_part = (float*)bufs[kDAPart]; p.dD_part = (float*)bufs[kDDPart];
  p.dt_b = strides[3]; p.dt_s = strides[4]; p.dt_h = strides[5];
  p.B = B; p.S = S; p.H = H; p.nc = S / chunk; p.chunk = chunk;
  p.nT = chunk / kTile; p.npair = p.nT * (p.nT + 1) / 2;
  p.a_bf16 = a_bf16; p.d_bf16 = d_bf16;
  const int64_t states = (int64_t)B * p.nc * H * kP;      // rows of a state
  const int64_t pairs = (int64_t)B * p.nc * p.npair * 2 * kTile;
  if (states >= INT32_MAX || pairs >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tdy, tb, tc, tdsb, thb, tdcb;
  if (!encode_map(encode, &tx, bufs[kX], P, S, H, B, strides[1], strides[2],
                  strides[0], kTile) ||
      !encode_map(encode, &tdy, bufs[kDy], P, S, H, B, strides[11],
                  strides[12], strides[10], kTile) ||
      !encode_map(encode, &tb, bufs[kB], N, S, 1, B, strides[7], 0,
                  strides[6], kTile) ||
      !encode_map(encode, &tc, bufs[kC], N, S, 1, B, strides[9], 0,
                  strides[8], kTile) ||
      !encode_map(encode, &tdsb, p.ds_bf, N, states, 1, 1, N, 0, 0, kTile) ||
      !encode_map(encode, &thb, p.h_bf, N, states, 1, 1, N, 0, 0, kTile) ||
      !encode_map(encode, &tdcb, p.dcb, kTile, pairs, 1, 1, kTile, 0, 0,
                  kTile))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if ((err = set_smem((const void*)ssd_bwd_dstate_wgmma, kDStateSmem)) ||
      (err = set_smem((const void*)ssd_bwd_pair, kPairSmem)) ||
      (err = set_smem((const void*)ssd_bwd_shared, kSharedSmem)) ||
      (err = set_smem((const void*)ssd_bwd_chunk_wgmma, kChunkSmem)))
    return err;
  const int heads = B * p.nc * H;
  ssd_bwd_dstate_wgmma<<<heads, kThreads, kDStateSmem, s>>>(tdy, tc, p);
  if ((err = (int)cudaGetLastError())) return err;
  const int total = B * H * (kP * kN / 4);
  ssd_bwd_state_pass_wgmma<<<total / kPassThreads, kPassThreads, 0, s>>>(
      reinterpret_cast<const float4*>(p.dstates), p.chunk_sum,
      reinterpret_cast<const float4*>(p.dh_final),
      reinterpret_cast<const float4*>(p.h_before),
      reinterpret_cast<uint2*>(p.ds_bf), reinterpret_cast<uint2*>(p.h_bf),
      p.hds, H, p.nc, total);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_pair<<<B * p.nc * p.npair, 2 * kThreads, kPairSmem, s>>>(
      tx, tdy, tb, tc, p);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_shared<<<B * p.nc * p.nT * 2, 2 * kThreads, kSharedSmem, s>>>(
      tx, tdy, tb, tc, tdsb, thb, tdcb, p);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_chunk_wgmma<<<heads, kThreads, kChunkSmem, s>>>(tx, tdy, tb, tdsb,
                                                          p);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_reduce_dad<<<(H + kThreads - 1) / kThreads, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
