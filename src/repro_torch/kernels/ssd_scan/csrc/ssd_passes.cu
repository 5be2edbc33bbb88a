// Mamba-2 SSD chunked forward scan for Hopper (sm_90a), bf16: Mamba-2's
// chunk-parallel form in three passes, every product on wgmma.
//
// Replaces the Pallas TPU kernel ssd_scan_pallas (_ssd_kernel) of
// src/repro/kernels/ssd_scan/ssd_scan.py for bf16 inputs at the shapes
// these passes tile (head dim P = 64, state N = 128, a chunk that is a
// multiple of 64 up to 256, TMA-aligned views: mamba2-780m's prefill);
// ssd_scan.wgmma_path in the wrapper decides, and every other call (fp32,
// other widths, unaligned views) runs ssd_scan.cu's kernel.
//
// What it computes (c = chunk, j = chunk index, acs = the cumulative sum
// of a_t = dt_t A within the chunk; x [B,S,H,P], dt [B,S,H], B and C
// [B,S,N]):
//   pass 1, ssd_chunk_state, one block per (b, j, h):
//     S_j = sum_s (x_s exp(acs_end - acs_s) dt_s) B_s^T   [P, N], fp32
//     and acs_end, the chunk's total log decay;
//   pass 2, ssd_state_pass, sequential over j, parallel over (b, h, P N):
//     h_before_j = h, then h <- exp(acs_end_j) h + S_j; h_before in bf16
//     (the operand dtype of pass 3), the last h as fp32 h_final; and, where
//     autograd records the call, h_before in fp32 as well (the backward's
//     statistics, ssd_scan_bwd.cu);
//   pass 3, ssd_chunk_out, one warpgroup per (b, j, h, 64-row t-tile):
//     y_t = exp(acs_t) C_t . h_before_j
//         + sum_{s <= t} (C_t . B_s) exp(acs_t - acs_s) dt_s x_s + D x_t.
// The three compose to the reference's chunked scan (ref.ssd_chunked; the
// plain version of each pass is in ref.py).  Accumulation is fp32
// throughout; the only roundings to bf16 are of product operands: x exp(..)
// dt (pass 1), h_before, and the masked, scaled scores (pass 3).  exp is
// evaluated only where s <= t (ex2.approx, in log2 units).
//
// What bounds it on an H100 SXM: at mamba2-780m's prefill [4, 32768, 48,
// 64], N 128, c 256, the passes do 6.0e11 FLOP on the tensor cores (per
// (b, j, h): C.B^T on the 10 tiles at or below the diagonal 10.5 M,
// scores.x 5.2 M, C.h^T 4.2 M, the chunk state 4.2 M), 0.6 ms at 989
// TFLOP/s, and move about 4.8 GB through device memory (x twice, y, the
// fp32 chunk states written and read, h_before written and read), 1.4 ms
// at 3.35 TB/s: bytes, two thirds of them the passes' own scratch.
//
// Why this decomposition: PR 13's kernel gave one block a whole (b, h) and
// walked its chunks in order (192 blocks at batch 4, 48 at batch 1: the
// card was not filled) and ran three of its four products on fp32 FMAs.
// Here the only sequential part is pass 2's elementwise recurrence over
// chunk boundaries, which streams 6 bytes a state element per chunk; pass
// 1 has B * nc * H blocks and pass 3 four times as many warpgroups (24,576
// and 98,304 at the main path, 6,144 and 24,576 at batch 1), each a
// 64-row wgmma problem.  C.B^T does not depend on the head; it is
// recomputed by each head's warpgroup from tiles the block shares (taking
// it out altogether saved 5% of the call on the H100, PERF.md).  Fusing
// passes 1 and 2 by a look-back across blocks would save the fp32 states'
// round trip (1.6 GB at the main path) and is later work.
//
//   pass 1: 128 threads (one warpgroup).  Thread 0 starts every copy by TMA
//     (128-byte swizzle): x and B in 64-row slices, each slice on its own
//     mbarrier.  Meanwhile the block reads its dt column (stride H) and
//     computes acs by a warp-shuffle scan.  As each slice lands, the threads
//     scale its x rows by tail_s = exp(acs_end - acs_s) dt_s in place
//     (cheaper than B: 64 columns, not 128), fence the generic writes to
//     the async proxy, and run S_j += (x tail)^T B by wgmma m64n128k16 with
//     both operands MN-major from shared memory (the transpose bits).
//     96 KB of tiles at c = 256: two blocks an SM.
//   pass 2: 256 threads, four state elements each; the loads of 8 chunks
//     are issued before their updates (they do not depend on h).
//   pass 3: 256 threads, two warpgroups, one head each (a head past H
//     repeats the last and stores nothing).  Thread 0 brings C_t (64 x 128)
//     and then, through a 2-stage ring of 32 KB, both heads' h_before_j
//     followed by each s-tile's B (64 x 128, shared) and both heads' x
//     (64 x 64); a stage is refilled after a block barrier shows every
//     warp's wgmma done with it.  O = C_t h_before^T by wgmma m64n64k16
//     (both K-major), scaled by exp(acs_t) in registers; then per s-tile
//     S = C_t B_s^T (m64n64k16), the decay and dt in registers, and O += S
//     x_s by wgmma with S from registers as bf16 and x MN-major.  Off the
//     diagonal the decay splits at the s-tile's last step e into a row
//     factor 2^(acs2_t - acs2_e) and a column factor 2^(acs2_e - acs2_s)
//     dt_s computed once a block, both at most 1 (two ex2 a thread, not
//     32); the diagonal tile takes the exact, masked form.  y = O + D x_t
//     is written over the diagonal tile's x in shared memory and stored by
//     TMA as one box.  88 KB and 128 registers: two blocks (four
//     warpgroups) an SM; the t-tiles of a (b, j, head pair) run next to
//     each other, heaviest first, so its x and h_before come from L2.
//     Tried on the H100 (PERF.md): one head a block, three blocks an SM,
//     read 4-7% slower; a third ring stage, with fewer blocks an SM,
//     10-20% slower; storing y from registers 0.23 ms slower a call.
// Each wgmma's fence .. wait window is straight-line code touching no
// operand register (see flash_attention.cu: ptxas otherwise serialises).
#include <cuda.h>                     // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"                 // TMA, mbarriers, wgmma

namespace {

constexpr int kP = 64;                // head dim: one 128-byte bf16 row
constexpr int kN = 128;               // state: two 64-column boxes
constexpr int kTile = 64;             // rows of a TMA box and of a t-tile
constexpr int kMaxChunk = 256;
constexpr int kThreads = 128;         // one warpgroup
constexpr int kStages = 2;            // pass 3's ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kBoxBytes = kTile * 128;              // 64 x 64 bf16
constexpr uint32_t kRowTile = 2 * kBoxBytes;             // 64 x 128 bf16

struct Params {
  const void* dt;
  const void* A;
  const void* D;
  int64_t dt_b, dt_s, dt_h;           // strides in elements
  int H, nc, chunk, a_bf16, d_bf16;
};

__device__ __forceinline__ float load_scalar(const void* p, int i,
                                             int bf16) {
  return bf16 ? __bfloat162float(((const __nv_bfloat16*)p)[i])
              : ((const float*)p)[i];
}

// The cumulative log decay of the first n steps of chunk j for (b, h):
// acs[i] = mul * sum_{k <= i} dt_k A, and dts[i] = dt_i, in shared memory
// (n <= 256), by the 128 threads of one warpgroup (tid is the thread's
// index in it; every thread of the block calls this together).  Warp w
// scans steps 64 w .. 64 w + 63, two a lane, by shuffles; the warps'
// totals are added in order.  The result for step i depends only on steps
// <= i, so passes that scan different lengths agree on the common steps.
__device__ __forceinline__ void chunk_cumsum(const Params& p, int b, int j,
                                             int h, int n, float mul,
                                             float* acs, float* dts,
                                             float* warp_tot, int tid) {
  const float A = load_scalar(p.A, h, p.a_bf16);
  const __nv_bfloat16* dtg = (const __nv_bfloat16*)p.dt + b * p.dt_b +
                             h * p.dt_h + (int64_t)j * p.chunk * p.dt_s;
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
    acs[i] = r0 * mul;
    dts[i] = d0;
  }
  if (i + 1 < n) {
    acs[i + 1] = (r0 + x1) * mul;
    dts[i + 1] = d1;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// pass 1: chunk states
// ---------------------------------------------------------------------------

size_t state_smem_bytes(int chunk) {
  return 1024 + 3 * (size_t)chunk * 128 + 4 * (3 * kMaxChunk + 4) +
         8 * (chunk / kTile);
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_b,
                       float* __restrict__ states,
                       float* __restrict__ chunk_sum, const Params p) {
  const int c = p.chunk, nq = c / kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sX = (raw + 1023) & ~1023u;   // [c][64]: x, then x tail
  unsigned char* gX = smem_raw + (sX - raw);
  const uint32_t sB = sX + c * 128;            // B: two [c][64] halves
  float* acs = reinterpret_cast<float*>(gX + 3 * c * 128);
  float* dts = acs + kMaxChunk;
  float* tail = dts + kMaxChunk;
  float* warp_tot = tail + kMaxChunk;
  const uint32_t bar = sX + 3 * c * 128 + 4 * (3 * kMaxChunk + 4);

  int blk = blockIdx.x;
  const int h = blk % p.H;
  blk /= p.H;
  const int j = blk % p.nc, b = blk / p.nc;
  const int s0 = j * c;

  if (threadIdx.x == 0) {
    for (int q = 0; q < nq; ++q) mbar_init(bar + 8 * q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < nq; ++q) {
      const uint32_t bq = bar + 8 * q;
      mbar_expect_tx(bq, 3 * kBoxBytes);
      tma_load(sX + q * kBoxBytes, &tm_x, bq, 0, s0 + q * kTile, h, b);
      tma_load(sB + q * kBoxBytes, &tm_b, bq, 0, s0 + q * kTile, 0, b);
      tma_load(sB + c * 128 + q * kBoxBytes, &tm_b, bq, 64, s0 + q * kTile,
               0, b);
    }
  }
  chunk_cumsum(p, b, j, h, c, 1.f, acs, dts, warp_tot, threadIdx.x);
  const float a_end = acs[c - 1];
  for (int i = threadIdx.x; i < c; i += kThreads)
    tail[i] = expf(a_end - acs[i]) * dts[i];
  if (threadIdx.x == 0) chunk_sum[((int64_t)b * p.H + h) * p.nc + j] = a_end;
  __syncthreads();

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int q = 0; q < nq; ++q) {
    mbar_wait(bar + 8 * q, 0);
    // x rows of slice q times tail, in place: 64 rows of eight 16-byte
    // pieces (the swizzle permutes pieces within a row, not rows)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int piece = threadIdx.x + kThreads * k;
      const int r = q * kTile + piece / 8;
      uint4* ptr = reinterpret_cast<uint4*>(gX + r * 128 + piece % 8 * 16);
      uint4 v = *ptr;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
      const float w = tail[r];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 f = __bfloat1622float2(e[m]);
        e[m] = __floats2bfloat162_rn(f.x * w, f.y * w);
      }
      *ptr = v;
    }
    fence_proxy_async();
    __syncthreads();
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t off = (q * kTile + 16 * kk) * 128;
      wgmma_ss_tt(d, sw128_desc(sX + off, c * 128, 1024),
                       sw128_desc(sB + off, c * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);
  }

  // d[p][n]: thread (warp, g, t) holds rows 16 warp + g (+ 8), columns
  // 8 jj + 2 t (+ 1)
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4,
            t = threadIdx.x % 4;
  float* out = states + (((int64_t)b * p.nc + j) * p.H + h) * kP * kN +
               (16 * warp + g) * kN + 2 * t;
#pragma unroll
  for (int jj = 0; jj < kN / 8; ++jj) {
    *reinterpret_cast<float2*>(out + 8 * jj) =
        make_float2(d[4 * jj], d[4 * jj + 1]);
    *reinterpret_cast<float2*>(out + 8 * kN + 8 * jj) =
        make_float2(d[4 * jj + 2], d[4 * jj + 3]);
  }
}

// ---------------------------------------------------------------------------
// pass 2: the state across chunk boundaries
// ---------------------------------------------------------------------------

constexpr int kPassThreads = 256;
constexpr int kAhead = 8;             // chunks whose loads are in flight

__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float4* __restrict__ states,
                      const float* __restrict__ chunk_sum,
                      uint2* __restrict__ h_before,
                      float4* __restrict__ h_before32,
                      float4* __restrict__ h_final, int H, int nc,
                      int total) {
  constexpr int kPN4 = kP * kN / 4;   // float4s of one (b, j, h) state
  const int i = blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= total) return;
  const int bh = i / kPN4, e = i % kPN4;
  const int b = bh / H, h = bh % H;
  const float* cs = chunk_sum + (int64_t)bh * nc;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < nc; j0 += kAhead) {
    float4 sv[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (j0 + k < nc) {
        sv[k] = __ldcs(states + (((int64_t)b * nc + j0 + k) * H + h) * kPN4 +
                       e);
        dec[k] = expf(cs[j0 + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (j0 + k < nc) {
        uint2 hb;
        hb.x = pack_bf16(hv.x, hv.y);
        hb.y = pack_bf16(hv.z, hv.w);
        const int64_t at = (((int64_t)b * nc + j0 + k) * H + h) * kPN4 + e;
        h_before[at] = hb;
        if (h_before32) h_before32[at] = hv;
        hv.x = fmaf(dec[k], hv.x, sv[k].x);
        hv.y = fmaf(dec[k], hv.y, sv[k].y);
        hv.z = fmaf(dec[k], hv.z, sv[k].z);
        hv.w = fmaf(dec[k], hv.w, sv[k].w);
      }
    }
  }
  h_final[(int64_t)bh * kPN4 + e] = hv;
}

// ---------------------------------------------------------------------------
// pass 3: chunk outputs
// ---------------------------------------------------------------------------

constexpr int kHeads = 2;             // heads a block, one warpgroup each
constexpr int kOutThreads = kHeads * kThreads;
// a stage holds item 0, each head's h_before, or an s-tile's B and each
// head's x
constexpr uint32_t kHbBytes = kHeads * kRowTile;
constexpr uint32_t kTileBytes = kRowTile + kHeads * kBoxBytes;
constexpr uint32_t kOutStage = kHbBytes > kTileBytes ? kHbBytes : kTileBytes;
constexpr int kOutFloats = 3 * kMaxChunk + 4;   // a warpgroup's arrays
constexpr size_t kOutSmemBytes = 1024 + kRowTile + kStages * kOutStage +
                                 4 * kHeads * kOutFloats + 8 * (1 + kStages);

__global__ void __launch_bounds__(kOutThreads, 4 / kHeads)
ssd_chunk_out_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_c,
                     const __grid_constant__ CUtensorMap tm_h,
                     const __grid_constant__ CUtensorMap tm_y,
                     const Params p) {
  const int c = p.chunk, nT = c / kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sC = (raw + 1023) & ~1023u;   // C_t [64][128]
  unsigned char* gC = smem_raw + (sC - raw);
  const uint32_t ring = sC + kRowTile;         // stage k at + k kOutStage
  // the warpgroup index, warp-uniform so that ptxas sees uniform control
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / kThreads, 0);
  const int tid = threadIdx.x % kThreads;
  float* acs = reinterpret_cast<float*>(gC + kRowTile +
                                        kStages * kOutStage) +
               wg * kOutFloats;                // this head's, log2 units
  float* dts = acs + kMaxChunk;
  float* fcol = dts + kMaxChunk;               // off-diagonal column factors
  float* warp_tot = fcol + kMaxChunk;
  const uint32_t bar_c = sC + kRowTile + kStages * kOutStage +
                         4 * kHeads * kOutFloats;
  const uint32_t full = bar_c + 8;             // stage k at + 8 k

  const int pairs = (p.H + kHeads - 1) / kHeads;
  int blk = blockIdx.x;
  const int tt = nT - 1 - blk % nT;            // heaviest t-tile first
  blk /= nT;
  const int hp = blk % pairs;
  blk /= pairs;
  const int j = blk % p.nc, b = blk / p.nc;
  const int s0 = j * c, t0 = tt * kTile, nS = tt + 1;
  // a warpgroup past the last head repeats it and stores nothing
  const bool live = hp * kHeads + wg < p.H;
  const int h = min(hp * kHeads + wg, p.H - 1);

  // item 0 is both heads' h_before, item i >= 1 the s-tile i - 1's B and
  // both heads' x
  auto issue = [&](int item, int st) {
    const uint32_t dst = ring + st * kOutStage, fb = full + 8 * st;
    mbar_expect_tx(fb, item == 0 ? kHbBytes : kTileBytes);
    for (int k = 0; k < kHeads; ++k) {
      const int hk = min(hp * kHeads + k, p.H - 1);
      if (item == 0) {
        const int row = ((b * p.nc + j) * p.H + hk) * kP;
        tma_load(dst + k * kRowTile, &tm_h, fb, 0, row, 0, 0);
        tma_load(dst + k * kRowTile + kBoxBytes, &tm_h, fb, 64, row, 0, 0);
      } else {
        tma_load(dst + kRowTile + k * kBoxBytes, &tm_x, fb, 0,
                 s0 + (item - 1) * kTile, hk, b);
      }
    }
    if (item > 0) {
      const int u0 = s0 + (item - 1) * kTile;
      tma_load(dst, &tm_b, fb, 0, u0, 0, b);
      tma_load(dst + kBoxBytes, &tm_b, fb, 64, u0, 0, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_c, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_c, kRowTile);
    tma_load(sC, &tm_c, bar_c, 0, s0 + t0, 0, b);
    tma_load(sC + kBoxBytes, &tm_c, bar_c, 64, s0 + t0, 0, b);
    for (int item = 0; item < kStages && item <= nS; ++item)
      issue(item, item);
  }
  __syncwarp();
  // log2 units: exp(acs_t - acs_s) = 2^(acs2_t - acs2_s)
  chunk_cumsum(p, b, j, h, t0 + kTile, kLog2e, acs, dts, warp_tot, tid);
  // Off the diagonal (s-tile u < t's tile), exp(acs_t - acs_s) is split at
  // the tile's last step e: 2^(acs2_t - acs2_e) 2^(acs2_e - acs2_s), both
  // at most 1.  fcol holds the second factor times dt_s.
  for (int i = tid; i < t0; i += kThreads)
    fcol[i] = ex2(acs[i | (kTile - 1)] - acs[i]) * dts[i];
  __syncthreads();

  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;   // rows within the t-tile
  const float la0 = acs[t0 + r0], la1 = acs[t0 + r1];

  // O = exp(acs_t) C_t h_before^T
  float o[32];
  mbar_wait(bar_c, 0);
  mbar_wait(full, 0);
  const uint32_t hb = ring + wg * kRowTile;
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < kN; kd += 16) {
    const uint32_t off = (kd / 64) * kBoxBytes + (kd % 64) * 2;
    wgmma_ss(o, sw128_desc(sC + off, 16, 1024),
                 sw128_desc(hb + off, 16, 1024), kd > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  const float e0 = ex2(la0), e1 = ex2(la1);
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    o[i] *= e0;
    o[i + 1] *= e0;
    o[i + 2] *= e1;
    o[i + 3] *= e1;
  }
  __syncthreads();                             // stage 0 is free
  if (threadIdx.x == 0 && nS >= kStages) issue(kStages, 0);
  __syncwarp();

  for (int it = 1; it <= nS; ++it) {
    const int st = it % kStages, u = it - 1;
    const uint32_t sb = ring + st * kOutStage;
    mbar_wait(full + 8 * st, (it / kStages) & 1);
    // S = C_t B_u^T
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < kN; kd += 16) {
      const uint32_t off = (kd / 64) * kBoxBytes + (kd % 64) * 2;
      wgmma_ss(sc, sw128_desc(sC + off, 16, 1024),
                   sw128_desc(sb + off, 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    // scores: S exp(acs_t - acs_s) dt_s for s <= t, else 0
    const int sbase = u * kTile + 2 * t;
    if (u == tt) {                             // the diagonal: exact, masked
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int s = sbase + (i / 4) * 8 + (i & 1);
        const int r = (i & 2) ? r1 : r0;
        const float la = (i & 2) ? la1 : la0;
        sc[i] = s - u * kTile <= r ? sc[i] * ex2(la - acs[s]) * dts[s] : 0.f;
      }
    } else {
      const float last = acs[u * kTile + kTile - 1];
      const float f0 = ex2(la0 - last), f1 = ex2(la1 - last);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int s = sbase + (i / 4) * 8 + (i & 1);
        sc[i] *= ((i & 2) ? f1 : f0) * fcol[s];
      }
    }
    // bf16 scores as wgmma's register A operand: accumulator chunks 2kk and
    // 2kk + 1 are the 16 s of step kk
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    // O += S x_u: this head's x, MN-major (P contiguous), 16 rows a step
    const uint32_t xs = sb + kRowTile + wg * kBoxBytes;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs(o, pa[kk], sw128_desc(xs + kk * 16 * 128, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (it < nS) {                             // the last x stays for D x_t
      __syncthreads();
      if (threadIdx.x == 0 && it + kStages <= nS) issue(it + kStages, st);
      __syncwarp();
    }
  }

  // y = O + D x_t, written over x_t in the diagonal tile (each thread
  // reads and writes the same elements), which TMA then stores as one
  // box.  In the tile's 128-byte swizzle row r's 16-byte piece k sits at
  // piece k ^ (r % 8), and r % 8 == g.
  const float Dh = load_scalar(p.D, h, p.d_bf16);
  const uint32_t xd = ring + (nS % kStages) * kOutStage + kRowTile +
                      wg * kBoxBytes;
  unsigned char* xs = gC + (xd - sC);
#pragma unroll
  for (int jj = 0; jj < kP / 8; ++jj) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
          xs + r * 128 + ((jj ^ g) * 16) + 4 * t);
      const float2 xv = __bfloat1622float2(*e);
      *e = __floats2bfloat162_rn(fmaf(Dh, xv.x, o[4 * jj + 2 * half]),
                                 fmaf(Dh, xv.y, o[4 * jj + 2 * half + 1]));
    }
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kThreads)
               : "memory");                    // this warpgroup's tile
  if (tid == 0 && live) tma_store(&tm_y, xd, 0, s0 + t0, h, b);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

bool tiled(int B, int S, int H, int P, int N, int chunk) {
  return B > 0 && H > 0 && P == kP && N == kN && chunk > 0 &&
         chunk % kTile == 0 && chunk <= kMaxChunk && S % chunk == 0;
}

Params params(const void* dt, const void* A, const void* D, int S, int H,
              int chunk, const int64_t* st, int a_bf16, int d_bf16) {
  Params p;
  p.dt = dt; p.A = A; p.D = D;
  p.dt_b = st[3]; p.dt_s = st[4]; p.dt_h = st[5];
  p.H = H; p.nc = S / chunk; p.chunk = chunk;
  p.a_bf16 = a_bf16; p.d_bf16 = d_bf16;
  return p;
}

}  // namespace

// Plain C entry points, loaded with ctypes; each launches one pass on
// `stream` and returns the CUDA error (0 when the launch was accepted).
// Shapes the passes do not tile (P != 64, N != 128, a chunk that is not a
// multiple of 64 up to 256, S % chunk != 0) and views TMA cannot map
// return cudaErrorInvalidValue.  x [B,S,H,P], dt [B,S,H], B and C [B,S,N]
// (bf16) and y [B,S,H,P] are given by their strides as for ssd_scan_launch
// (13 int64: x's b, s, h; dt's b, s, h; B's b, s; C's b, s; y's b, s, h),
// the last axis of x, B, C and y contiguous; A and D are contiguous [H]
// (a_bf16, d_bf16: bf16, else fp32).  Scratch, contiguous: states fp32
// [B, nc, H, P, N], chunk_sum fp32 [B, H, nc], h_before bf16
// [B, nc, H, P, N]; h_final fp32 [B, H, P, N].  ssd_state_pass_stats_launch
// also writes h_before in fp32, [B, nc, H, P, N] contiguous, into
// h_before32 (null: not written, as ssd_state_pass_launch).

extern "C" int ssd_chunk_state_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    float* states, float* chunk_sum, int B, int S, int H, int P, int N,
    int chunk, const int64_t* strides, int a_bf16, void* stream) {
  if (!tiled(B, S, H, P, N, chunk)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap tx, tb;
  if (!encode_map(encode, &tx, x, P, S, H, B, strides[1], strides[2],
                  strides[0], kTile) ||
      !encode_map(encode, &tb, Bm, N, S, 1, B, strides[7], 0, strides[6],
                  kTile))
    return (int)cudaErrorInvalidValue;
  const Params p = params(dt, A, nullptr, S, H, chunk, strides, a_bf16, 0);
  const size_t smem = state_smem_bytes(chunk);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<<<B * p.nc * H, kThreads, smem,
                           (cudaStream_t)stream>>>(tx, tb, states, chunk_sum,
                                                   p);
  return (int)cudaGetLastError();
}

extern "C" int ssd_state_pass_stats_launch(const float* states,
                                           const float* chunk_sum,
                                           void* h_before, float* h_before32,
                                           float* h_final, int B, int nc,
                                           int H, int P, int N,
                                           void* stream) {
  if (B <= 0 || nc <= 0 || H <= 0 || P != kP || N != kN)
    return (int)cudaErrorInvalidValue;
  const int total = B * H * (kP * kN / 4);
  ssd_state_pass_kernel<<<(total + kPassThreads - 1) / kPassThreads,
                          kPassThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(states), chunk_sum,
      reinterpret_cast<uint2*>(h_before),
      reinterpret_cast<float4*>(h_before32),
      reinterpret_cast<float4*>(h_final), H, nc, total);
  return (int)cudaGetLastError();
}

extern "C" int ssd_state_pass_launch(const float* states,
                                     const float* chunk_sum, void* h_before,
                                     float* h_final, int B, int nc, int H,
                                     int P, int N, void* stream) {
  return ssd_state_pass_stats_launch(states, chunk_sum, h_before, nullptr,
                                     h_final, B, nc, H, P, N, stream);
}

extern "C" int ssd_chunk_out_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* h_before, void* y, int B,
    int S, int H, int P, int N, int chunk, const int64_t* strides,
    int a_bf16, int d_bf16, void* stream) {
  if (!tiled(B, S, H, P, N, chunk)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const Params p = params(dt, A, D, S, H, chunk, strides, a_bf16, d_bf16);
  CUtensorMap tx, tb, tc, th, ty;
  if (!encode_map(encode, &tx, x, P, S, H, B, strides[1], strides[2],
                  strides[0], kTile) ||
      !encode_map(encode, &tb, Bm, N, S, 1, B, strides[7], 0, strides[6],
                  kTile) ||
      !encode_map(encode, &tc, Cm, N, S, 1, B, strides[9], 0, strides[8],
                  kTile) ||
      !encode_map(encode, &th, h_before, N, (int64_t)B * p.nc * H * P, 1, 1,
                  N, 0, 0, kTile) ||
      !encode_map(encode, &ty, y, P, S, H, B, strides[11], strides[12],
                  strides[10], kTile))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kOutSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int pairs = (H + kHeads - 1) / kHeads;
  ssd_chunk_out_kernel<<<B * p.nc * pairs * (chunk / kTile), kOutThreads,
                         kOutSmemBytes, (cudaStream_t)stream>>>(tx, tb, tc,
                                                                th, ty, p);
  return (int)cudaGetLastError();
}
