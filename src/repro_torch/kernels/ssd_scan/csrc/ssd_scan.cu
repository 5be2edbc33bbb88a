// Mamba-2 SSD chunked forward scan for Hopper (sm_90a): the simple path.
//
// Replaces the Pallas TPU kernel ssd_scan_pallas (_ssd_kernel) of
// src/repro/kernels/ssd_scan/ssd_scan.py, and with it the transpose of x
// and the broadcast of B and C over heads in its wrapper: this kernel reads
// x [B,S,H,P] and dt [B,S,H] by strides and B, C [B,S,N] by (b, s) alone.
// It runs every call that ssd_passes.cu's three wgmma passes do not tile
// (ssd_scan.wgmma_path in the wrapper decides): fp32, which needs IEEE
// fp32 products, and other widths, chunks or unaligned views.  bf16 at
// mamba2-780m's widths, the main path, takes the passes.
//
// What it computes, for each (batch b, head h), chunk by chunk in order
// (c = chunk, acs = the cumulative sum of a_t = dt_t * A within the chunk,
// left to right, as the reference's cumsum):
//   y_t   = sum_{s <= t} (C_t . B_s) exp(acs_t - acs_s) dt_s x_s     (intra)
//         + exp(acs_t) C_t . h[p, :]                               (inter)
//         + D x_t
//   h    <- exp(acs_{c-1}) h + sum_s (x_s exp(acs_{c-1} - acs_s) dt_s) B_s^T
// with h [P, N] zero before the first chunk; y is written in x's dtype and
// the last h as fp32 h_final [B,H,P,N].  All arithmetic is fp32, as in the
// TPU kernel: x, dt, B, C, A and D are upcast at load, every product of
// fp32 values is a plain IEEE fp32 FMA (no TF32), and exp is evaluated
// only where s <= t, so a masked entry never multiplies an inf.  For bf16
// inputs C.B^T runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate): bf16 products are exact in fp32.
//
// What bounds it on an H100 SXM: per (b, h, chunk) it does about
// c^2 N + c^2 P + 4 c P N operations (C.B^T and scores.x on the lower
// triangle, C.h^T and the state update).  At mamba2-780m's prefill
// [4, 32768, 48, 64], N 128, c 256 that is 5.2e11 per layer: 7.7 ms at the
// 67 TFLOP/s of fp32 outside the tensor cores, 0.52 ms at the bf16 tensor
// cores' 989 TFLOP/s, against 0.51 ms to move x, y, dt, B and C once at
// 3.35 TB/s.  Here only C.B^T (a third of the operations) reaches the
// tensor cores, so the floor is near the fp32 one.
//
// The design is simple and right first.  The TPU grid is (B, H, chunks)
// with the chunk axis sequential and h carried in VMEM scratch; here one
// block of 256 threads owns one (b, h) and walks the chunks itself, with h
// in registers (and a copy in shared memory for C.h^T).  B*H blocks: 192 at
// the main path's B = 4, 48 at B = 1, so the card is underfilled at small
// batch; splitting P across blocks (recomputing C.B^T) or Mamba-2's
// three-pass form are the later ways to fill it.  A chunk of 256 rows does
// not fit as the TPU holds it (C.B^T alone is 256 KB in fp32), so it is
// tiled: 64-row t-tiles of C against 64-row s-tiles of B and x with s <= t,
// tiles above the diagonal skipped and [c, c] never materialised.  Each
// thread computes 4 x 4 (or 4 x 8) outputs of a product from float4 rows
// in shared memory (h kept transposed, [N][P], for C.h^T); rows are padded
// by 4 floats, so the loads of a warp hit distinct banks or broadcast.
// The state update rides along the last t-tile, which visits every s-tile
// of the chunk.
// A tile arrives as 16-byte vectors, each thread issuing all of its loads
// before it stores any: with one block on an SM nothing else hides their
// latency.  The cumulative sum runs on one thread, in order.  wgmma, a
// pipelined load of the next tile, more blocks per SM and the other
// products on the tensor cores (which needs a split of the fp32 operands)
// are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // rows of a t- or s-tile
constexpr int kMaxP = 64;             // thread mappings cover P <= 64 ...
constexpr int kMaxN = 128;            // ... and N <= 128
constexpr int kLdS = kTile + 4;       // padded row of the scores tile

struct Params {
  const void* x;
  const void* dt;
  const void* A;
  const void* Bm;
  const void* Cm;
  const void* D;
  void* y;
  float* h_final;
  float* h_before;   // fp32 [B,nc,H,P,N], the state before each chunk, or
                     // null (not written)
  // strides in elements; the last axis of x, B, C and y is contiguous
  int64_t x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s, y_b, y_s, y_h;
  int H, S, P, N, chunk;
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

// rows [r0, r0 + L) of a [S, cols] stream (row stride `rs`, columns
// contiguous) into shared memory rows of `ld` floats, upcast to fp32, and,
// where `raw` is given, rows of `ld_raw` elements as they are.  With one
// block on an SM nothing hides a load's latency, so a thread issues all of
// its 16-byte loads of the tile (up to kBatch) before it stores any; a
// stream that is not 16-byte aligned goes element by element.
constexpr int kBatch = 8;
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t rs, int r0, int L,
                                          int cols, T* raw = nullptr,
                                          int ld_raw = 0) {
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
        if (idx < total) {
          const int r = idx / per_row, c = idx % per_row * V;
          store_vec(dst + r * ld + c, v[k], T());
          if (raw) *reinterpret_cast<uint4*>(raw + r * ld_raw + c) = v[k];
        }
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < L * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    const T v = src[(int64_t)(r0 + r) * rs + c];
    dst[r * ld + c] = to_f(v);
    if (raw) raw[r * ld_raw + c] = v;
  }
}

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for one m16n8k16 tile: bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (C_t . B_s) exp(acs_t - acs_s) dt_s into row tr, column sr of the scores
// tile (t = t0 + tr, s = u0 + sr within the chunk); 0 above the diagonal,
// where exp is never evaluated.
__device__ __forceinline__ void put_score(float* Ss, float cb, int tr,
                                          int sr, int L, int t0, int u0,
                                          const float* acs,
                                          const float* dts) {
  if (tr >= L || sr >= L) return;
  const int t = t0 + tr, s = u0 + sr;
  Ss[tr * kLdS + sr] = s <= t ? cb * expf(acs[t] - acs[s]) * dts[s] : 0.f;
}

// The scores tile from fp32 copies of C and B with IEEE FMAs: thread
// (ti, ci) owns rows t = 4 ti + i and columns s = ci + 16 j.
__device__ __forceinline__ void scores_fma(float* Ss, const float* Cs,
                                           const float* Bs, int ldN, int N,
                                           int L, int t0, int u0,
                                           const float* acs,
                                           const float* dts) {
  const int ti = threadIdx.x / 16, ci = threadIdx.x % 16;
  float sc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
  for (int n = 0; n < N; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cv[i] = ld4(Cs + min(4 * ti + i, L - 1) * ldN + n);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = ld4(Bs + min(ci + 16 * j, L - 1) * ldN + n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(cv[i].x, bv[j].x, sc[i][j]);
        sc[i][j] = fmaf(cv[i].y, bv[j].y, sc[i][j]);
        sc[i][j] = fmaf(cv[i].z, bv[j].z, sc[i][j]);
        sc[i][j] = fmaf(cv[i].w, bv[j].w, sc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      put_score(Ss, sc[i][j], 4 * ti + i, ci + 16 * j, L, t0, u0, acs, dts);
}

// The scores tile from the bf16 C and B on the tensor cores (bf16 products
// are exact in fp32; N % 16 == 0): warp w owns rows 16 (w % 4) + [0, 16)
// and columns 32 (w / 4) + [0, 32), four m16n8k16 tiles side by side.
__device__ __forceinline__ void scores_mma(float* Ss,
                                           const __nv_bfloat16* C16,
                                           const __nv_bfloat16* B16,
                                           int ld16, int N, int L, int t0,
                                           int u0, const float* acs,
                                           const float* dts) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int r0 = 16 * (warp % 4), c0 = 32 * (warp / 4);
  float d[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  const __nv_bfloat16* ca = C16 + (r0 + g) * ld16 + 2 * q;
  const __nv_bfloat16* ba = B16 + (c0 + g) * ld16 + 2 * q;
  for (int k = 0; k < N; k += 16) {
    const uint32_t a[4] = {pair(ca + k), pair(ca + 8 * ld16 + k),
                           pair(ca + k + 8), pair(ca + 8 * ld16 + k + 8)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16* br = ba + 8 * j * ld16 + k;
      mma_bf16(d[j], a, pair(br), pair(br + 8));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      put_score(Ss, d[j][e], r0 + g + 8 * (e / 2), c0 + 8 * j + 2 * q + e % 2,
                L, t0, u0, acs, dts);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const Params p) {
  const int N = p.N, P = p.P, c = p.chunk;
  const int L = c < kTile ? c : kTile;          // rows of a tile
  const int nT = c / L;
  const int ldN = N + 4, ldX = P + 4;
  extern __shared__ __align__(16) float sm[];
  float* Cs = sm;                   // [L][ldN]  C of the t-tile
  float* Bs = Cs + L * ldN;         // [L][ldN]  B of the s-tile
  float* Hs = Bs + L * ldN;         // [N][ldX]  h^T before this chunk
  float* Xs = Hs + N * ldX;         // [L][ldX]  x of the s-tile
  float* Ss = Xs + L * ldX;         // [L][kLdS] scores[t][s]
  float* dts = Ss + L * kLdS;       // [c] dt
  float* acs = dts + c;             // [c] cumulative log decay
  float* eacs = acs + c;            // [c] exp(acs)
  float* tail = eacs + c;           // [c] exp(acs_end - acs) dt
  // bf16 inputs: C and B of the tiles as they are, for the tensor cores
  const bool mma = sizeof(T) == 2 && N % 16 == 0;
  const int ld16 = N + 8;           // rows padded by 16 bytes
  // (kTile rows even where L < kTile: the fragments read all of them)
  T* C16 = reinterpret_cast<T*>(tail + c);        // [kTile][ld16]
  T* B16 = C16 + kTile * ld16;                     // [kTile][ld16]
  const int smem_floats = (int)(tail + c - sm) +
                          (mma ? kTile * ld16 : 0);
  for (int i = threadIdx.x; i < smem_floats; i += kThreads) sm[i] = 0.f;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int tid = threadIdx.x, ti = tid / 16, ci = tid % 16;
  const float A = load_scalar(p.A, h, p.a_bf16);
  const float Dh = load_scalar(p.D, h, p.d_bf16);
  const T* xg = (const T*)p.x + b * p.x_b + h * p.x_h;
  const T* dtg = (const T*)p.dt + b * p.dt_b + h * p.dt_h;
  const T* Bg = (const T*)p.Bm + b * p.b_b;
  const T* Cg = (const T*)p.Cm + b * p.c_b;
  T* yg = (T*)p.y + b * p.y_b + h * p.y_h;

  // the state h[p][n], p = 4 ti + i, n = 4 ci + j % 4 + 64 (j / 4)
  float hr[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) hr[i][j] = 0.f;

  const int nc = p.S / c;
  for (int ic = 0; ic < nc; ++ic) {
    const int s0 = ic * c;
    if (p.h_before) {                 // the backward's statistics: h now
      float* hb = p.h_before + (((int64_t)b * nc + ic) * p.H + h) * P * N;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * ti + i;
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
          const int n = 4 * ci + 64 * jh;
          if (q < P && n < N)
            *reinterpret_cast<float4*>(hb + q * N + n) =
                make_float4(hr[i][4 * jh], hr[i][4 * jh + 1],
                            hr[i][4 * jh + 2], hr[i][4 * jh + 3]);
        }
      }
    }
    __syncthreads();                  // the last chunk's readers are done
    for (int i = tid; i < c; i += kThreads)
      dts[i] = to_f(dtg[(int64_t)(s0 + i) * p.dt_s]);
    __syncthreads();
    if (tid == 0) {                   // the reference's cumsum order
      float run = 0.f;
#pragma unroll 8
      for (int i = 0; i < c; ++i) {
        run += dts[i] * A;
        acs[i] = run;
      }
    }
    __syncthreads();
    const float a_end = acs[c - 1];
    for (int i = tid; i < c; i += kThreads) {
      eacs[i] = expf(acs[i]);
      tail[i] = expf(a_end - acs[i]) * dts[i];
    }

    float hx[4][8];                   // sum_s (x_s tail_s) B_s^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) hx[i][j] = 0.f;

    for (int tt = 0; tt < nT; ++tt) {
      const int t0 = tt * L;
      __syncthreads();                // Cs and Xs are free
      load_rows(Cs, ldN, Cg, p.c_s, s0 + t0, L, N, mma ? C16 : nullptr,
                ld16);
      __syncthreads();

      // inter: y[t][q] = exp(acs_t) * sum_n C[t][n] h[q][n],
      // t = 4 ti + i, q = 4 ci + j
      const int q0 = min(4 * ci, P - 4);
      float ya[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ya[i][j] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = ld4(Cs + min(4 * ti + i, L - 1) * ldN + n);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 hv = ld4(Hs + (n + k) * ldX + q0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cik = k == 0 ? cv[i].x : k == 1 ? cv[i].y
                            : k == 2 ? cv[i].z : cv[i].w;
            ya[i][0] = fmaf(cik, hv.x, ya[i][0]);
            ya[i][1] = fmaf(cik, hv.y, ya[i][1]);
            ya[i][2] = fmaf(cik, hv.z, ya[i][2]);
            ya[i][3] = fmaf(cik, hv.w, ya[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = eacs[t0 + min(4 * ti + i, L - 1)];
#pragma unroll
        for (int j = 0; j < 4; ++j) ya[i][j] *= e;
      }

      for (int ss = 0; ss <= tt; ++ss) {
        const int u0 = ss * L;
        __syncthreads();              // Bs, Xs and Ss are free
        load_rows(Bs, ldN, Bg, p.b_s, s0 + u0, L, N, mma ? B16 : nullptr,
                  ld16);
        load_rows(Xs, ldX, xg, p.x_s, s0 + u0, L, P);
        __syncthreads();

        // scores[t][s] = (C_t . B_s) exp(acs_t - acs_s) dt_s for s <= t
        if (mma)
          scores_mma(Ss, reinterpret_cast<const __nv_bfloat16*>(C16),
                     reinterpret_cast<const __nv_bfloat16*>(B16), ld16, N,
                     L, t0, u0, acs, dts);
        else
          scores_fma(Ss, Cs, Bs, ldN, N, L, t0, u0, acs, dts);

        if (tt == nT - 1) {
          // the last t-tile visits every s-tile: the state update's sum,
          // p = 4 ti + i, n = 4 ci + j % 4 + 64 (j / 4)
          for (int sr = 0; sr < L; ++sr) {
            const float w = tail[u0 + sr];
            const float4 xv = ld4(Xs + sr * ldX + min(4 * ti, P - 4));
            const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
            const float4 b0 = ld4(Bs + sr * ldN + min(4 * ci, N - 4));
            const float4 b1 = ld4(Bs + sr * ldN + min(64 + 4 * ci, N - 4));
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                hx[i][j] = fmaf(xw[i], bv[j], hx[i][j]);
          }
        }
        __syncthreads();              // Ss is written

        // intra: y[t][q] += sum_s scores[t][s] x[s][q]
        for (int sr = 0; sr < L; sr += 4) {
          float4 sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sv[i] = ld4(Ss + min(4 * ti + i, L - 1) * kLdS + sr);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 xv = ld4(Xs + (sr + k) * ldX + q0);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float s = k == 0 ? sv[i].x : k == 1 ? sv[i].y
                            : k == 2 ? sv[i].z : sv[i].w;
              ya[i][0] = fmaf(s, xv.x, ya[i][0]);
              ya[i][1] = fmaf(s, xv.y, ya[i][1]);
              ya[i][2] = fmaf(s, xv.z, ya[i][2]);
              ya[i][3] = fmaf(s, xv.w, ya[i][3]);
            }
          }
        }
      }

      // Xs holds the diagonal s-tile, whose rows are this t-tile's x
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tr = 4 * ti + i;
        if (tr >= L) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * ci + j;
          if (q < P)
            store(yg + (int64_t)(s0 + t0 + tr) * p.y_s + q,
                  ya[i][j] + Xs[tr * ldX + q] * Dh);
        }
      }
    }

    // h <- exp(acs_end) h + hx, and its copy for the next chunk's C.h^T
    const float e_end = expf(a_end);
    __syncthreads();                  // every reader of Hs is done
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) hr[i][j] = e_end * hr[i][j] + hx[i][j];
      const int n = 4 * ci + j % 4 + 64 * (j / 4);
      if (4 * ti < P && n < N)
        *reinterpret_cast<float4*>(Hs + n * ldX + 4 * ti) =
            make_float4(hr[0][j], hr[1][j], hr[2][j], hr[3][j]);
    }
  }

  float* hf = p.h_final + (int64_t)(b * p.H + h) * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = 4 * ti + i;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = 4 * ci + 64 * jh;
      if (q < P && n < N)
        *reinterpret_cast<float4*>(hf + q * N + n) =
            make_float4(hr[i][4 * jh], hr[i][4 * jh + 1], hr[i][4 * jh + 2],
                        hr[i][4 * jh + 3]);
    }
  }
}

size_t smem_bytes(int P, int N, int chunk, bool bf16) {
  const int L = chunk < kTile ? chunk : kTile;
  const size_t raw = bf16 && N % 16 == 0 ? (size_t)kTile * (N + 8) : 0;
  return sizeof(float) * ((size_t)2 * L * (N + 4) + (size_t)N * (P + 4) +
                          (size_t)L * (P + 4) + (size_t)L * kLdS +
                          4 * (size_t)chunk + raw);
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.P, p.N, p.chunk, sizeof(T) == 2);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<B * p.H, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  x [B,S,H,P], dt [B,S,H],
// B and C [B,S,N] and y [B,S,H,P] are given by their strides (13 int64:
// x's b, s, h; dt's b, s, h; B's b, s; C's b, s; y's b, s, h), with the
// last axis of x, B, C and y contiguous; A and D are contiguous [H];
// h_final is a contiguous fp32 [B,H,P,N].  io_bf16 selects bf16 for x, dt,
// B, C and y (else fp32); a_bf16 and d_bf16 the same for A and D.
// Launches on `stream` and returns the CUDA error (0 when the launch was
// accepted); shapes the thread mappings do not cover (P > 64, N > 128,
// P or N or chunk not a multiple of 4, a chunk that is neither <= 64 nor a
// multiple of 64, S % chunk != 0) return cudaErrorInvalidValue.
// ssd_scan_stats_launch also writes the state before each chunk, fp32
// [B,nc,H,P,N] contiguous, into h_before (the backward's statistics; null:
// not written, and the kernel computes as ssd_scan_launch's).
extern "C" int ssd_scan_stats_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, void* y, float* h_final, float* h_before,
    int B, int S, int H, int P, int N, int chunk, const int64_t* strides,
    int io_bf16, int a_bf16, int d_bf16, void* stream) {
  if (P <= 0 || P > kMaxP || P % 4 || N <= 0 || N > kMaxN || N % 4 ||
      chunk <= 0 || chunk % 4 || (chunk > kTile && chunk % kTile) ||
      S % chunk || B <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = dt; p.A = A; p.Bm = Bm; p.Cm = Cm; p.D = D;
  p.y = y; p.h_final = h_final; p.h_before = h_before;
  p.x_b = strides[0]; p.x_s = strides[1]; p.x_h = strides[2];
  p.dt_b = strides[3]; p.dt_s = strides[4]; p.dt_h = strides[5];
  p.b_b = strides[6]; p.b_s = strides[7];
  p.c_b = strides[8]; p.c_s = strides[9];
  p.y_b = strides[10]; p.y_s = strides[11]; p.y_h = strides[12];
  p.H = H; p.S = S; p.P = P; p.N = N; p.chunk = chunk;
  p.a_bf16 = a_bf16; p.d_bf16 = d_bf16;
  cudaStream_t s = (cudaStream_t)stream;
  return io_bf16 ? launch<__nv_bfloat16>(p, B, s) : launch<float>(p, B, s);
}

extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, void* y, float* h_final, int B, int S,
    int H, int P, int N, int chunk, const int64_t* strides, int io_bf16,
    int a_bf16, int d_bf16, void* stream) {
  return ssd_scan_stats_launch(x, dt, A, Bm, Cm, D, y, h_final, nullptr, B,
                               S, H, P, N, chunk, strides, io_bf16, a_bf16,
                               d_bf16, stream);
}
