// Mamba-2 SSD chunked scan for Hopper (sm_90a): the backward.
//
// The JAX package has no backward kernel: it trains mamba2 by autodiff of
// its jnp ssd_chunked (src/repro/models/ssm.py:106), the function its
// Pallas kernel ssd_scan_pallas (src/repro/kernels/ssd_scan/ssd_scan.py:77)
// computes.  This is the gradient of that function, for every call the
// forward kernels take (fp32 and bf16, P <= 64, N <= 128, both multiples of
// 4, a chunk that is a multiple of 4 up to 64 or of 64 up to 1024, x, dt,
// B, C and dy read by strides).  Given dy [B,S,H,P], the cotangent of y,
// and dh_final [B,H,P,N] (fp32, or none), it writes dx [B,S,H,P], ddt
// [B,S,H], dB and dC [B,S,N] in x's dtype and dA, dD [H] in A's and D's.
// It reads the fp32 state before each chunk, h_before [B,nc,H,P,N], which
// the forward writes when autograd records it (ssd_scan.cu,
// ssd_passes.cu's state pass).
//
// What it computes (c = chunk, j = chunk index, acs = the cumulative sum of
// a_t = dt_t A within the chunk, L[t,s] = exp(acs_t - acs_s) [s <= t],
// CB = C B^T, G = dy x^T, tail_s = exp(acs_end - acs_s) dt_s, h = h_before_j;
// ref.py holds each pass in plain torch):
//   (a) ssd_bwd_dstate, one block per (b, j, h): dh_y_j = sum_t exp(acs_t)
//       dy_t^T C_t [P, N], what y asks of the state before chunk j, and
//       acs_end_j;
//   (b) ssd_bwd_state_pass, sequential over j from the last, parallel over
//       (b, h, P N): g <- dh_final; dS_j = g; g <- dh_y_j + exp(acs_end_j) g.
//       dS_j, the gradient of the state after chunk j, overwrites dh_y_j;
//   (c) ssd_bwd_chunk, one block per (b, j, h): every local gradient
//         dx_s  = sum_t CB L dt_s dy_t + tail_s dS B_s + D dy_s,
//         dC_t  = sum_s dCB[t,s] B_s + exp(acs_t) dy_t h,   dCB = G L dt_s,
//         dB_s  = sum_t dCB[t,s] C_t + tail_s x_s dS,
//         ddt_s = sum_t CB L G + exp(acs_end - acs_s) <x_s B_s^T, dS>
//                 + A da_s,
//       with da the reverse cumulative sum of the gradient of acs (from L,
//       from exp(acs_t) of the inter-chunk term, from the tail and from
//       the decay exp(acs_end) <h, dS> into the next chunk), and the
//       chunk's parts of dA (sum_s dt_s da_s) and dD (sum_t dy_t . x_t).
//       dB and dC go out per head, fp32 [B,S,H,N];
//   (d) ssd_bwd_reduce: dB, dC summed over the heads in order, dA and dD
//       over (b, j) in order.
// Everything is fp32 on the upcast inputs, every product an IEEE fp32 FMA
// (no tensor cores: the bf16 path rounds no operand of its own); exp is
// evaluated only where s <= t.  No atomics: every sum runs in a fixed
// order, so two launches give the same bits.
//
// What bounds it on an H100 SXM, at mamba2-780m's training shape [1, 4096,
// 48, 64], N 128, c 256 (16 chunks): per (b, j, h) this kernel takes the
// products C B^T and dy x^T on the 10 tiles at or below the diagonal (64 x
// 64 each), 10.5 M and 5.2 M FLOP, scores^T dy 5.2 M, dCB B and dCB^T C
// 10.5 M each, dy h, x dS, B dS and (a)'s exp(acs) dy^T C 4.2 M each: 58.7
// MFLOP, 45.1 GFLOP in all.  The function needs less: C B^T does not
// depend on the head, and dCB B, dCB^T C can be taken once on the heads'
// sum of dCB (B and C are shared by the heads), which leaves 21.4 GFLOP,
// 0.022 ms at the bf16 tensor cores' 989 TFLOP/s.  It must move x, dy, dx
// (25.2 MB each in bf16), h_before (25.2 MB fp32), dt, ddt, B, C, dB and
// dC: 106 MB, 0.032 ms at 3.35 TB/s.  So bytes bound it, at 0.032 ms
// (chip_smoke.py's bound_ms).  On the 67 TFLOP/s of fp32 outside the
// tensor cores, where this kernel runs, the least work takes 0.32 ms and
// this kernel's 0.67 ms.  Its own traffic adds the per-head partials of dB
// and dC (201 MB written and read at that shape) and the scratch of (a)
// and (b) (25.2 MB, written, read and rewritten): about 0.2 ms of bytes.
//
// The design is simple and right first.  Blocks of (c) own a (b, j, h),
// 768 at the training shape: the card is filled, and every sum a block
// takes over its chunk is its own.  What the heads share (dB, dC) leaves
// as per-head fp32 partials that (d) sums in order.  The other way, a
// block per (b, j) that walks its heads in order, needs no partials but
// gives 16 blocks at [1, 4096]: 132 SMs would sit idle for the sake of
// 0.06 ms of bytes.  At [4, 32768] (serving's shape, where no gradient is
// taken) the partials would be 3.2 GB; a head-blocked split or summing
// dCB over heads first is later work.  In (c) a 256-thread block walks
// the s-tiles (64 rows) in order and, for each, the t-tiles at or below
// it: dx and dB of the s-tile accumulate in registers, dC of the t-tile
// accumulates in its fp32 partial in device memory (each thread reads
// back only what it wrote, in s-tile order; L2 holds a block's 128 KB).
// The gradient of acs collects by rows and columns in shared memory; one
// thread takes the in-order sums along the chunk (the cumulative sums,
// dA's and dD's parts).  h and dS stay in shared memory for the block's
// life (h only until the s-tiles start).  One block an SM (183 KB of
// shared memory at c = 256); wgmma, TMA and bf16 operands are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // rows of a t- or s-tile
constexpr int kMaxP = 64;             // thread mappings cover P <= 64 ...
constexpr int kMaxN = 128;            // ... and N <= 128
constexpr int kLdS = kTile + 4;       // padded row of a [t][s] tile
constexpr int kAhead = 8;             // chunks whose loads are in flight

// The buffers of one launch, in the order of ssd_scan_bwd_launch's `bufs`.
enum Buf {
  kX, kDt, kA, kB, kC, kD, kDy, kHBefore, kDhFinal,        // inputs
  kDx, kDdt, kDA, kDB, kDC, kDD,                          // outputs
  kDStates, kChunkSum, kDBHeads, kDCHeads, kDAPart, kDDPart,  // scratch
  kNumBufs
};

struct Params {
  const void* x;
  const void* dt;
  const void* A;
  const void* Bm;
  const void* Cm;
  const void* D;
  const void* dy;
  const float* h_before;   // [B,nc,H,P,N]
  const float* dh_final;   // [B,H,P,N] or null
  void* dx;                // [B,S,H,P], x's dtype
  void* ddt;               // [B,S,H]
  void* dA;                // [H], A's dtype
  void* dB;                // [B,S,N]
  void* dC;                // [B,S,N]
  void* dD;                // [H], D's dtype
  float* dstates;          // [B,nc,H,P,N]: dh_y, then dS
  float* chunk_sum;        // [B,H,nc]
  float* dB_heads;         // [B,S,H,N]
  float* dC_heads;         // [B,S,H,N]
  float* dA_part;          // [B,H,nc]
  float* dD_part;          // [B,H,nc]
  // strides in elements; the last axis of x, B, C and dy is contiguous
  int64_t x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s, dy_b, dy_s,
      dy_h;
  int B, H, S, P, N, chunk, nc;
  int a_bf16, d_bf16;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float load_scalar(const void* p, int i,
                                             int bf16) {
  return bf16 ? __bfloat162float(((const __nv_bfloat16*)p)[i])
              : ((const float*)p)[i];
}
__device__ __forceinline__ void store_scalar(void* p, int i, float v,
                                             int bf16) {
  if (bf16)
    ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(v);
  else
    ((float*)p)[i] = v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One 16-byte vector of T, upcast to fp32, stored from dst on.
__device__ __forceinline__ void store_vec(float* dst, uint4 v, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<float4*>(&v);
}
__device__ __forceinline__ void store_vec(float* dst, uint4 v,
                                          __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// rows [r0, r0 + L) of a [rows, cols] stream (row stride `rs`, columns
// contiguous) into shared memory rows of `ld` floats, upcast to fp32 (as
// ssd_scan.cu loads them: a thread issues up to kBatch 16-byte loads
// before it stores any; a stream that is not 16-byte aligned goes element
// by element).
constexpr int kBatch = 8;
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t rs, int r0, int L,
                                          int cols) {
  constexpr int V = 16 / sizeof(T);             // elements per vector
  if (cols % V == 0 && rs % V == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int per_row = cols / V, total = L * per_row;
    for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int idx = base + k * kThreads;
        if (idx < total)
          v[k] = *reinterpret_cast<const uint4*>(
              src + (int64_t)(r0 + idx / per_row) * rs + idx % per_row * V);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int idx = base + k * kThreads;
        if (idx < total)
          store_vec(dst + idx / per_row * ld + idx % per_row * V, v[k], T());
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < L * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    dst[r * ld + c] = to_f(src[(int64_t)(r0 + r) * rs + c]);
  }
}

// The sum over the 16 lanes of a half warp (threads with one `ti`), in a
// fixed order; every lane gets it.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The chunk's dt and the cumulative log decay acs (thread 0, left to
// right, as the reference's cumsum), in shared memory.
template <typename T>
__device__ __forceinline__ void chunk_cumsum(const T* dtg, int64_t dt_s,
                                             int s0, int c, float A,
                                             float* dts, float* acs) {
  for (int i = threadIdx.x; i < c; i += kThreads)
    dts[i] = to_f(dtg[(int64_t)(s0 + i) * dt_s]);
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int i = 0; i < c; ++i) {
      run += dts[i] * A;
      acs[i] = run;
    }
  }
  __syncthreads();
}

// The thread's columns n = 4 ci + k % 4 + 64 (k / 4) of a state row, as
// two float4 loads (clamped into [0, N); `live` says which half exists).
__device__ __forceinline__ void state_cols(const float* row, int ci, int N,
                                           float* out8) {
  const float4 a = ld4(row + min(4 * ci, N - 4));
  const float4 b = ld4(row + min(64 + 4 * ci, N - 4));
  out8[0] = a.x; out8[1] = a.y; out8[2] = a.z; out8[3] = a.w;
  out8[4] = b.x; out8[5] = b.y; out8[6] = b.z; out8[7] = b.w;
}

// ---------------------------------------------------------------------------
// (a) dh_y_j = sum_t exp(acs_t) dy_t^T C_t, and acs_end_j
// ---------------------------------------------------------------------------

size_t dstate_smem_bytes(int P, int N, int chunk) {
  const int L = chunk < kTile ? chunk : kTile;
  return sizeof(float) *
         ((size_t)L * (N + 4) + (size_t)L * (P + 4) + 3 * (size_t)chunk);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dstate_kernel(const Params p) {
  const int N = p.N, P = p.P, c = p.chunk;
  const int L = c < kTile ? c : kTile, nT = c / L;
  const int ldN = N + 4, ldP = P + 4;
  extern __shared__ __align__(16) float sm[];
  float* Ct = sm;                   // [L][ldN]  C of the t-tile
  float* Gt = Ct + L * ldN;         // [L][ldP]  exp(acs_t) dy_t
  float* dts = Gt + L * ldP;        // [c]
  float* acs = dts + c;             // [c]
  float* eacs = acs + c;            // [c] exp(acs)

  int blk = blockIdx.x;
  const int h = blk % p.H;
  blk /= p.H;
  const int j = blk % p.nc, b = blk / p.nc;
  const int s0 = j * c, tid = threadIdx.x, ti = tid / 16, ci = tid % 16;
  const T* dyg = (const T*)p.dy + b * p.dy_b + h * p.dy_h;
  const T* Cg = (const T*)p.Cm + b * p.c_b;
  chunk_cumsum((const T*)p.dt + b * p.dt_b + h * p.dt_h, p.dt_s, s0, c,
               load_scalar(p.A, h, p.a_bf16), dts, acs);
  for (int i = tid; i < c; i += kThreads) eacs[i] = expf(acs[i]);

  float acc[4][8];                  // [p = 4 ti + i][n = 4 ci + k % 4 + ..]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
  const int p0 = min(4 * ti, P - 4);
  for (int tt = 0; tt < nT; ++tt) {
    const int t0 = tt * L;
    __syncthreads();                  // the last tile's readers are done
    load_rows(Ct, ldN, Cg, p.c_s, s0 + t0, L, N);
    load_rows(Gt, ldP, dyg, p.dy_s, s0 + t0, L, P);
    __syncthreads();
    for (int idx = tid; idx < L * P; idx += kThreads)
      Gt[idx / P * ldP + idx % P] *= eacs[t0 + idx / P];
    __syncthreads();
    for (int r = 0; r < L; ++r) {
      const float4 g = ld4(Gt + r * ldP + p0);
      float cv[8];
      state_cols(Ct + r * ldN, ci, N, cv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(get(g, i), cv[k],
                                                     acc[i][k]);
    }
  }

  float* out = p.dstates + (((int64_t)b * p.nc + j) * p.H + h) * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = 4 * ti + i;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = 4 * ci + 64 * jh;
      if (q < P && n < N)
        *reinterpret_cast<float4*>(out + q * N + n) =
            make_float4(acc[i][4 * jh], acc[i][4 * jh + 1],
                        acc[i][4 * jh + 2], acc[i][4 * jh + 3]);
    }
  }
  if (tid == 0)
    p.chunk_sum[((int64_t)b * p.H + h) * p.nc + j] = acs[c - 1];
}

// ---------------------------------------------------------------------------
// (b) the state's gradient from the last chunk to the first
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass_kernel(float4* __restrict__ dstates,
                          const float* __restrict__ chunk_sum,
                          const float4* __restrict__ dh_final, int H, int nc,
                          int pn4, int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int bh = i / pn4, e = i % pn4;
  const int b = bh / H, h = bh % H;
  const float* cs = chunk_sum + (int64_t)bh * nc;
  float4 g = dh_final ? dh_final[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = nc - 1; j0 >= 0; j0 -= kAhead) {
    float4 d[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (j0 - k >= 0) {
        d[k] = dstates[(((int64_t)b * nc + j0 - k) * H + h) * pn4 + e];
        dec[k] = expf(cs[j0 - k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (j0 - k >= 0) {
        dstates[(((int64_t)b * nc + j0 - k) * H + h) * pn4 + e] = g;
        g.x = fmaf(dec[k], g.x, d[k].x);
        g.y = fmaf(dec[k], g.y, d[k].y);
        g.z = fmaf(dec[k], g.z, d[k].z);
        g.w = fmaf(dec[k], g.w, d[k].w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (c) every local gradient of a (b, j, h)
// ---------------------------------------------------------------------------

size_t chunk_smem_bytes(int P, int N, int chunk) {
  const int L = chunk < kTile ? chunk : kTile;
  const int hrows = L > P ? L : P;
  return sizeof(float) *
         ((size_t)(P + hrows + L) * (N + 4) + 2 * (size_t)L * (P + 4) +
          (2 * (size_t)L + 16) * kLdS + 7 * (size_t)chunk + 8);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const Params p) {
  const int N = p.N, P = p.P, c = p.chunk;
  const int L = c < kTile ? c : kTile, nT = c / L;
  const int ldN = N + 4, ldP = P + 4, hrows = L > P ? L : P;
  extern __shared__ __align__(16) float sm[];
  float* dSs = sm;                  // [P][ldN]   dS
  float* HB = dSs + P * ldN;        // [hrows][ldN] h, then B of the s-tile
  float* Ct = HB + hrows * ldN;     // [L][ldN]   C of the t-tile
  float* Xu = Ct + L * ldN;         // [L][ldP]   x of the s-tile
  float* Gt = Xu + L * ldP;         // [L][ldP]   dy of the t-tile
  float* Ss = Gt + L * ldP;         // [L][kLdS]  scores CB L dt_s
  float* Ks = Ss + L * kLdS;        // [L][kLdS]  dCB = G L dt_s
  float* colbuf = Ks + L * kLdS;    // [16][kLdS] column partials
  float* dts = colbuf + 16 * kLdS;  // [c] dt
  float* acs = dts + c;             // [c] cumulative log decay
  float* ddt_d = acs + c;           // [c] ddt not through acs
  float* dacs_r = ddt_d + c;        // [c] d acs_t as a row (t) index
  float* dacs_c = dacs_r + c;       // [c] d acs_s as a column (s) index
  float* tq = dacs_c + c;           // [c] tail_s <x_s B_s^T, dS>
  float* gdiag = tq + c;            // [c] dy_t . x_t
  float* red = gdiag + c;           // [8] warp partials
  for (int i = threadIdx.x; i < 5 * c + 8; i += kThreads) ddt_d[i] = 0.f;

  int blk = blockIdx.x;
  const int h = blk % p.H;
  blk /= p.H;
  const int j = blk % p.nc, b = blk / p.nc;
  const int s0 = j * c, tid = threadIdx.x, ti = tid / 16, ci = tid % 16;
  const float A = load_scalar(p.A, h, p.a_bf16);
  const float Dh = load_scalar(p.D, h, p.d_bf16);
  const T* xg = (const T*)p.x + b * p.x_b + h * p.x_h;
  const T* Bg = (const T*)p.Bm + b * p.b_b;
  const T* Cg = (const T*)p.Cm + b * p.c_b;
  const T* dyg = (const T*)p.dy + b * p.dy_b + h * p.dy_h;
  const int64_t HN = (int64_t)p.H * N;
  float* dCh = p.dC_heads + ((int64_t)b * p.S + s0) * HN + (int64_t)h * N;
  float* dBh = p.dB_heads + ((int64_t)b * p.S + s0) * HN + (int64_t)h * N;
  T* dxg = (T*)p.dx + ((int64_t)b * p.S + s0) * p.H * P + (int64_t)h * P;
  const int64_t state = (((int64_t)b * p.nc + j) * p.H + h) * P * N;

  chunk_cumsum((const T*)p.dt + b * p.dt_b + h * p.dt_h, p.dt_s, s0, c, A,
               dts, acs);
  const float a_end = acs[c - 1];
  load_rows(HB, ldN, p.h_before + state, N, 0, P, N);
  load_rows(dSs, ldN, p.dstates + state, N, 0, P, N);
  __syncthreads();

  // <h, dS>, for the decay exp(acs_end) of h into the next chunk
  float hds = 0.f;
  for (int i = tid; i < P * N; i += kThreads)
    hds = fmaf(HB[i / N * ldN + i % N], dSs[i / N * ldN + i % N], hds);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hds += __shfl_xor_sync(0xffffffffu, hds, o);
  if (tid % 32 == 0) red[tid / 32] = hds;

  // the thread's rows r = 4 ti + i of a tile and its state columns
  // n = 4 ci + k % 4 + 64 (k / 4) (live[k / 4]); P columns q0 + k
  const bool live[2] = {4 * ci < N, 64 + 4 * ci < N};
  const int q0 = min(4 * ci, P - 4);

  // the inter-chunk term: dC_t = exp(acs_t) dy_t h, the first part of each
  // t-tile's dC, and its acs gradient sum_n C_t[n] dC_t[n]
  for (int tt = 0; tt < nT; ++tt) {
    const int t0 = tt * L;
    __syncthreads();
    load_rows(Ct, ldN, Cg, p.c_s, s0 + t0, L, N);
    load_rows(Gt, ldP, dyg, p.dy_s, s0 + t0, L, P);
    __syncthreads();
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
    for (int q = 0; q < P; ++q) {
      float hv[8];
      state_cols(HB + q * ldN, ci, N, hv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = Gt[min(4 * ti + i, L - 1) * ldP + q];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(g, hv[k], acc[i][k]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(4 * ti + i, L - 1);
      const float e = expf(acs[t0 + r]);
      float cv[8];
      state_cols(Ct + r * ldN, ci, N, cv);
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[i][k] *= e;
        if (live[k / 4]) part = fmaf(cv[k], acc[i][k], part);
      }
      part = half_warp_sum(part);
      if (4 * ti + i < L) {
        if (ci == 0) dacs_r[t0 + r] += part;
#pragma unroll
        for (int jh = 0; jh < 2; ++jh)
          if (live[jh])
            *reinterpret_cast<float4*>(dCh + (int64_t)(t0 + r) * HN +
                                       4 * ci + 64 * jh) =
                make_float4(acc[i][4 * jh], acc[i][4 * jh + 1],
                            acc[i][4 * jh + 2], acc[i][4 * jh + 3]);
      }
    }
  }

  for (int uu = 0; uu < nT; ++uu) {
    const int u0 = uu * L;
    __syncthreads();                  // h and the last s-tile are done
    load_rows(HB, ldN, Bg, p.b_s, s0 + u0, L, N);
    load_rows(Xu, ldP, xg, p.x_s, s0 + u0, L, P);
    __syncthreads();

    // the state terms: dx_s = tail_s B_s dS^T, dB_s = tail_s x_s dS, and
    // the direct ddt and acs gradient of tail_s <x_s B_s^T, dS>
    float xa[4][4], ba[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) xa[i][k] = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) ba[i][k] = 0.f;
    }
    for (int n = 0; n < N; n += 4) {
      float4 bv[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bv[i] = ld4(HB + min(4 * ti + i, L - 1) * ldN + n);
#pragma unroll
      for (int k = 0; k < 4; ++k) dv[k] = ld4(dSs + (q0 + k) * ldN + n);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          xa[i][k] = fmaf(bv[i].x, dv[k].x, xa[i][k]);
          xa[i][k] = fmaf(bv[i].y, dv[k].y, xa[i][k]);
          xa[i][k] = fmaf(bv[i].z, dv[k].z, xa[i][k]);
          xa[i][k] = fmaf(bv[i].w, dv[k].w, xa[i][k]);
        }
    }
    for (int q = 0; q < P; ++q) {
      float dv[8];
      state_cols(dSs + q * ldN, ci, N, dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = Xu[min(4 * ti + i, L - 1) * ldP + q];
#pragma unroll
        for (int k = 0; k < 8; ++k) ba[i][k] = fmaf(xv, dv[k], ba[i][k]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(4 * ti + i, L - 1), s = u0 + r;
      const float w = expf(a_end - acs[s]), tail = w * dts[s];
      float bv[8];
      state_cols(HB + r * ldN, ci, N, bv);
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (live[k / 4]) part = fmaf(bv[k], ba[i][k], part);
        ba[i][k] *= tail;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) xa[i][k] *= tail;
      part = half_warp_sum(part);
      if (ci == 0 && 4 * ti + i < L) {
        ddt_d[s] += w * part;
        dacs_c[s] -= tail * part;
        tq[s] = tail * part;
      }
    }

    for (int tt = uu; tt < nT; ++tt) {
      const int t0 = tt * L;
      __syncthreads();                // Ct, Gt, Ss, Ks, colbuf are free
      load_rows(Ct, ldN, Cg, p.c_s, s0 + t0, L, N);
      load_rows(Gt, ldP, dyg, p.dy_s, s0 + t0, L, P);
      __syncthreads();

      // CB[t][s] and G[t][s] for t = t0 + 4 ti + i, s = u0 + ci + 16 k
      float cb[4][4], gg[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) cb[i][k] = gg[i][k] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = ld4(Ct + min(4 * ti + i, L - 1) * ldN + n);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          bv[k] = ld4(HB + min(ci + 16 * k, L - 1) * ldN + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            cb[i][k] = fmaf(cv[i].x, bv[k].x, cb[i][k]);
            cb[i][k] = fmaf(cv[i].y, bv[k].y, cb[i][k]);
            cb[i][k] = fmaf(cv[i].z, bv[k].z, cb[i][k]);
            cb[i][k] = fmaf(cv[i].w, bv[k].w, cb[i][k]);
          }
      }
      for (int q = 0; q < P; q += 4) {
        float4 gv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          gv[i] = ld4(Gt + min(4 * ti + i, L - 1) * ldP + q);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          xv[k] = ld4(Xu + min(ci + 16 * k, L - 1) * ldP + q);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            gg[i][k] = fmaf(gv[i].x, xv[k].x, gg[i][k]);
            gg[i][k] = fmaf(gv[i].y, xv[k].y, gg[i][k]);
            gg[i][k] = fmaf(gv[i].z, xv[k].z, gg[i][k]);
            gg[i][k] = fmaf(gv[i].w, xv[k].w, gg[i][k]);
          }
      }
      // scores, dCB and E = CB L G; the acs gradient of L: + sum_s E dt_s
      // on row t, - dt_s sum_t E on column s
      float colpart[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tr = 4 * ti + i, t = t0 + min(tr, L - 1);
        float rowpart = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int sr = ci + 16 * k, s = u0 + min(sr, L - 1);
          const bool in = tr < L && sr < L && s <= t;
          const float l = in ? expf(acs[t] - acs[s]) : 0.f;
          const float ld = l * dts[s], e = cb[i][k] * l * gg[i][k];
          if (tr < L && sr < L) {
            Ss[tr * kLdS + sr] = cb[i][k] * ld;
            Ks[tr * kLdS + sr] = gg[i][k] * ld;
          }
          rowpart = fmaf(e, dts[s], rowpart);
          colpart[k] += e;
          if (in && t == s) gdiag[t] = gg[i][k];
        }
        rowpart = half_warp_sum(rowpart);
        if (ci == 0 && tr < L) dacs_r[t] += rowpart;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) colbuf[ti * kLdS + ci + 16 * k] = colpart[k];
      __syncthreads();                // Ss, Ks and colbuf are written
      if (tid < L) {
        float ce = 0.f;
        for (int k = 0; k < 16; ++k) ce += colbuf[k * kLdS + tid];
        ddt_d[u0 + tid] += ce;
        dacs_c[u0 + tid] -= dts[u0 + tid] * ce;
      }

      // dx_s += sum_t scores[t][s] dy_t; dB_s += sum_t dCB[t][s] C_t
      for (int r = 0; r < L; ++r) {
        const float4 sv = ld4(Ss + r * kLdS + 4 * ti);
        const float4 kv = ld4(Ks + r * kLdS + 4 * ti);
        const float4 gv = ld4(Gt + r * ldP + q0);
        float cv[8];
        state_cols(Ct + r * ldN, ci, N, cv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s_i = get(sv, i), k_i = get(kv, i);
#pragma unroll
          for (int k = 0; k < 4; ++k) xa[i][k] = fmaf(s_i, get(gv, k),
                                                      xa[i][k]);
#pragma unroll
          for (int k = 0; k < 8; ++k) ba[i][k] = fmaf(k_i, cv[k], ba[i][k]);
        }
      }
      if (tt == uu) {                 // D dy_s: the s-tile's own rows
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 gv = ld4(Gt + min(4 * ti + i, L - 1) * ldP + q0);
#pragma unroll
          for (int k = 0; k < 4; ++k) xa[i][k] = fmaf(Dh, get(gv, k),
                                                      xa[i][k]);
        }
      }

      // dC_t += sum_s dCB[t][s] B_s, into the t-tile's partial
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
      for (int r = 0; r < L; ++r) {
        float bv[8];
        state_cols(HB + r * ldN, ci, N, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kv = Ks[min(4 * ti + i, L - 1) * kLdS + r];
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(kv, bv[k], acc[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * ti + i >= L) continue;
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
          if (!live[jh]) continue;
          float4* dst = reinterpret_cast<float4*>(
              dCh + (int64_t)(t0 + 4 * ti + i) * HN + 4 * ci + 64 * jh);
          float4 v = *dst;
          v.x += acc[i][4 * jh];
          v.y += acc[i][4 * jh + 1];
          v.z += acc[i][4 * jh + 2];
          v.w += acc[i][4 * jh + 3];
          *dst = v;
        }
      }
    }

    // the s-tile's dx (x's dtype) and dB partial
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ti + i;
      if (r >= L) continue;
      if (4 * ci < P) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          store(dxg + (int64_t)(u0 + r) * p.H * P + 4 * ci + k, xa[i][k]);
      }
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
        if (live[jh])
          *reinterpret_cast<float4*>(dBh + (int64_t)(u0 + r) * HN + 4 * ci +
                                     64 * jh) =
              make_float4(ba[i][4 * jh], ba[i][4 * jh + 1],
                          ba[i][4 * jh + 2], ba[i][4 * jh + 3]);
    }
  }

  // da = the reverse cumulative sum of d acs; ddt += A da; the chunk's
  // parts of dA and dD; one thread, in order
  __syncthreads();
  if (tid == 0) {
    float end = red[0];
    for (int w = 1; w < kThreads / 32; ++w) end += red[w];
    end *= expf(a_end);
    for (int s = 0; s < c; ++s) end += tq[s];
    float da = end, dA = 0.f, dD = 0.f;
    for (int t = c - 1; t >= 0; --t) {
      da += dacs_r[t] + dacs_c[t];
      ddt_d[t] = fmaf(A, da, ddt_d[t]);
      dA = fmaf(dts[t], da, dA);
    }
    for (int t = 0; t < c; ++t) dD += gdiag[t];
    const int64_t part = ((int64_t)b * p.H + h) * p.nc + j;
    p.dA_part[part] = dA;
    p.dD_part[part] = dD;
  }
  __syncthreads();
  T* ddtg = (T*)p.ddt + ((int64_t)b * p.S + s0) * p.H + h;
  for (int i = tid; i < c; i += kThreads)
    store(ddtg + (int64_t)i * p.H, ddt_d[i]);
}

// ---------------------------------------------------------------------------
// (d) the sums over heads and over (b, j)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const Params p) {
  const int n4 = p.N / 4;
  const int64_t rows = (int64_t)p.B * p.S * n4;   // float4s of dB (or dC)
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < 2 * rows) {
    const bool is_c = i >= rows;
    const int64_t r = is_c ? i - rows : i, bs = r / n4;
    const int n = (int)(r % n4) * 4;
    const float* src = (is_c ? p.dC_heads : p.dB_heads) + bs * p.H * p.N + n;
    float4 acc = ld4(src);
    for (int h = 1; h < p.H; ++h) {
      const float4 v = ld4(src + (int64_t)h * p.N);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    T* dst = (T*)(is_c ? p.dC : p.dB) + bs * p.N + n;
    store(dst, acc.x);
    store(dst + 1, acc.y);
    store(dst + 2, acc.z);
    store(dst + 3, acc.w);
  } else if (i - 2 * rows < p.H) {
    const int h = (int)(i - 2 * rows);
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
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int grid = p.B * p.nc * p.H;
  size_t smem = dstate_smem_bytes(p.P, p.N, p.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_dstate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_dstate_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int pn4 = p.P * p.N / 4, total = p.B * p.H * pn4;
  ssd_bwd_state_pass_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                              stream>>>(
      reinterpret_cast<float4*>(p.dstates), p.chunk_sum,
      reinterpret_cast<const float4*>(p.dh_final), p.H, p.nc, pn4, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = chunk_smem_bytes(p.P, p.N, p.chunk);
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t work = 2 * (int64_t)p.B * p.S * (p.N / 4) + p.H;
  ssd_bwd_reduce_kernel<T><<<(int)((work + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes: the four passes on `stream`;
// returns the CUDA error (0 when every launch was accepted).  `bufs` holds
// 21 device pointers in this order: x [B,S,H,P], dt [B,S,H], A [H], B and
// C [B,S,N], D [H], dy [B,S,H,P] (x, dt, B, C and dy by their strides, in
// x's dtype), h_before fp32 [B,nc,H,P,N], dh_final fp32 [B,H,P,N] or null;
// the outputs dx [B,S,H,P], ddt [B,S,H], dA [H], dB and dC [B,S,N], dD
// [H], contiguous, in the dtypes of x, dt, A, B, C and D; the fp32 scratch
// dstates [B,nc,H,P,N], chunk_sum [B,H,nc], dB_heads and dC_heads
// [B,S,H,N], dA_part and dD_part [B,H,nc].  `strides` is 13 int64: x's b,
// s, h; dt's b, s, h; B's b, s; C's b, s; dy's b, s, h, the last axis of
// x, B, C and dy contiguous.  io_bf16 selects bf16 for x, dt, B, C, dy and
// their gradients (else fp32); a_bf16 and d_bf16 the same for A, D and
// theirs.  Shapes the forward's kernel does not take (P > 64, N > 128, P or
// N or chunk not a multiple of 4, a chunk that is neither <= 64 nor a
// multiple of 64 up to 1024, S % chunk != 0) return
// cudaErrorInvalidValue.
extern "C" int ssd_scan_bwd_launch(void* const* bufs, int B, int S, int H,
                                   int P, int N, int chunk,
                                   const int64_t* strides, int io_bf16,
                                   int a_bf16, int d_bf16, void* stream) {
  if (P <= 0 || P > kMaxP || P % 4 || N <= 0 || N > kMaxN || N % 4 ||
      chunk <= 0 || chunk % 4 || chunk > 16 * kTile ||
      (chunk > kTile && chunk % kTile) || S <= 0 || S % chunk || B <= 0 ||
      H <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = bufs[kX]; p.dt = bufs[kDt]; p.A = bufs[kA]; p.Bm = bufs[kB];
  p.Cm = bufs[kC]; p.D = bufs[kD]; p.dy = bufs[kDy];
  p.h_before = (const float*)bufs[kHBefore];
  p.dh_final = (const float*)bufs[kDhFinal];
  p.dx = bufs[kDx]; p.ddt = bufs[kDdt]; p.dA = bufs[kDA]; p.dB = bufs[kDB];
  p.dC = bufs[kDC]; p.dD = bufs[kDD];
  p.dstates = (float*)bufs[kDStates];
  p.chunk_sum = (float*)bufs[kChunkSum];
  p.dB_heads = (float*)bufs[kDBHeads];
  p.dC_heads = (float*)bufs[kDCHeads];
  p.dA_part = (float*)bufs[kDAPart];
  p.dD_part = (float*)bufs[kDDPart];
  p.x_b = strides[0]; p.x_s = strides[1]; p.x_h = strides[2];
  p.dt_b = strides[3]; p.dt_s = strides[4]; p.dt_h = strides[5];
  p.b_b = strides[6]; p.b_s = strides[7];
  p.c_b = strides[8]; p.c_s = strides[9];
  p.dy_b = strides[10]; p.dy_s = strides[11]; p.dy_h = strides[12];
  p.B = B; p.H = H; p.S = S; p.P = P; p.N = N; p.chunk = chunk;
  p.nc = S / chunk;
  p.a_bf16 = a_bf16; p.d_bf16 = d_bf16;
  cudaStream_t s = (cudaStream_t)stream;
  return io_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
