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
//   as fp32 (bf16 products are exact in fp32), the running max m, the
//   denominator l and the accumulator are fp32, p is rounded to v's dtype
//   before p.v, l is clamped at 1e-30, and the output is in q's dtype.
//
// The masked value is the finite NEG_INF = -1e38, never -inf.  A row whose
// entries are all masked in a live tile gets m_new = NEG_INF and
// p = exp(0) = 1; a later tile of the same row holds a live key and wipes
// that with corr = exp(NEG_INF - m) = 0, so masked entries add exactly
// nothing.  With -inf the same code would give NaN.
//
// What bounds it on an H100 SXM: operations.  A causal layer of gemma2-9b's
// prefill (B=1, H=16, D=256, S=8192) has 33.6 M live (q, k) pairs per head,
// 4*D FLOP each: 5.5e11 FLOP, 0.56 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 0.10 ms to move q, k, v and o once at 3.35 TB/s.
//
// The design is simple and right first.  The TPU walks KV blocks in a
// sequential grid dimension and carries m, l and acc in VMEM scratch; here
// one thread block owns one (b*h, 64-row q tile) and loops over the KV
// tiles itself, skipping tiles that are causally or window-dead, so nothing
// crosses blocks.  The heaviest causal q tiles are scheduled first.
//   bf16: 4 warps, 16 q rows each.  Q, K and V tiles of 64 rows sit in
//     dynamic shared memory (3 x 64 x (D + 8) bf16: 101 KB at D = 256, over
//     the 48 KB static limit); each row is padded by 16 bytes so fragment
//     loads hit distinct banks.  Tiles arrive by cp.async, every copy of a
//     tile in flight at once, and V's copies land while QK^T and the
//     softmax run.  QK^T and PV run on the tensor cores through
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate); the S accumulator is
//     reused in registers as the A operand of PV, and the 16 x D fp32 output
//     accumulator of a warp lives in registers (D / 2 floats a thread).
//   fp32: 8 warps, plain IEEE fp32 FMAs (no TF32), 32-key tiles loaded by
//     cp.async; four threads share a q row, each holding 8 scores and D / 4
//     accumulators.
// wgmma, TMA and warp specialisation are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e38f;   // _flash_kernel's NEG_INF
constexpr int kBQ = 64;               // q rows per block

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
};

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
  const int n = in_range ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(saddr), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(saddr), "l"(src), "r"(n) : "memory");
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
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBK16 = 64;             // keys per tile
constexpr int kWarps16 = 4;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
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

// Start copying 64 rows of D bf16 (16-byte vectors) into a padded smem
// tile and commit them as one group; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile16(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            int64_t row_stride, int row0,
                                            int limit) {
  constexpr int LD = D + 8;
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < 64 * V; idx += kWarps16 * 32) {
    const int r = idx / V, c = (idx % V) * 8;
    const bool in = row0 + r < limit;
    copy_async<16>(dst + r * LD + c,
                   in ? src + (row0 + r) * row_stride + c : src, in);
  }
  copy_commit();
}

template <int D>
__global__ void __launch_bounds__(kWarps16 * 32, 1)
flash_fwd_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK16 * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;    // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const __nv_bfloat16* qg = (const __nv_bfloat16*)p.q + b * p.q_b + h * p.q_h;
  const __nv_bfloat16* kg = (const __nv_bfloat16*)p.k + b * p.k_b + hk * p.k_h;
  const __nv_bfloat16* vg = (const __nv_bfloat16*)p.v + b * p.v_b + hk * p.v_h;
  load_tile16<D>(Qs, qg, p.q_s, q0, p.Sq);

  // rows g and g + 8 of this warp's 16
  const int qp0 = q0 + warp * 16 + g, qp1 = qp0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int nk = (p.Sk + kBK16 - 1) / kBK16;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK16;
    if (!tile_live(p, q0, k0, kBK16)) continue;
    __syncthreads();                      // the last tile's reads are done
    load_tile16<D>(Ks, kg, p.k_s, k0, p.Sk);
    load_tile16<D>(Vs, vg, p.v_s, k0, p.Sk);
    copy_wait<1>();                       // Q and K have landed; V may not
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBK16 / 8][4];
#pragma unroll
    for (int j = 0; j < kBK16 / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* qw = Qs + (warp * 16) * LD;
#pragma unroll 4
    for (int kd = 0; kd < D; kd += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qw + g * LD + kd + 2 * t);
      a[1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + kd + 2 * t);
      a[2] = *reinterpret_cast<const uint32_t*>(qw + g * LD + kd + 8 + 2 * t);
      a[3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + kd + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < kBK16 / 8; ++j) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + kd + 2 * t;
        mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, softcap, mask; then the online-softmax update per row
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK16 / 8; ++j) {
      const int kp = k0 + j * 8 + 2 * t;
      s[j][0] = score(p, s[j][0], qp0, kp);
      s[j][1] = score(p, s[j][1], qp0, kp + 1);
      s[j][2] = score(p, s[j][2], qp1, kp);
      s[j][3] = score(p, s[j][3], qp1, kp + 1);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK16 / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    // l stays a per-thread partial sum (every thread of a row scales by the
    // same corr); the four partials of a row are added at the end.
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }

    copy_wait<0>();                       // V has landed
    __syncthreads();
    // acc += bf16(P) V: the S accumulator of n-tiles 2kk, 2kk+1 is the A
    // fragment of the kk-th 16-key step.
#pragma unroll
    for (int kk = 0; kk < kBK16 / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vr = v0 + j * 8;
        mma_bf16(acc[j], a, pack_bf16(vr[0], vr[LD]),
                 pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* og = (__nv_bfloat16*)p.o + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (qp0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + qp0 * p.o_s + d) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (qp1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + qp1 * p.o_s + d) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs
// ---------------------------------------------------------------------------

constexpr int kBK32 = 32;             // keys per tile
constexpr int kThreads32 = 256;       // four threads per q row

template <int D>
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
    if (!tile_live(p, q0, k0, kBK32)) continue;
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
      s[j] = score(p, s[j], qp, k0 + cq + 4 * j);
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

template <int D>
int launch_d(const Params& p, int B, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch(flash_fwd_bf16_kernel<D>, kWarps16 * 32,
                  sizeof(__nv_bfloat16) * (kBQ + 2 * kBK16) * (D + 8), p, B,
                  stream);
  return launch(flash_fwd_f32_kernel<D>, kThreads32,
                sizeof(float) * ((kBQ + kBK32) * (D + 1) + kBK32 * D +
                                 kBQ * (kBK32 + 1)),
                p, B, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v and o are [B, S, heads,
// D] views given by their strides (D contiguous); dtype_bf16 selects bf16
// (else fp32).  Launches on `stream` and returns the CUDA error (0 when the
// launch was accepted); an unsupported head_dim returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, const int64_t* strides, float scale,
    float softcap, int causal, int window, int dtype_bf16, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_b = strides[0]; p.q_s = strides[1]; p.q_h = strides[2];
  p.k_b = strides[3]; p.k_s = strides[4]; p.k_h = strides[5];
  p.v_b = strides[6]; p.v_s = strides[7]; p.v_h = strides[8];
  p.o_b = strides[9]; p.o_s = strides[10]; p.o_h = strides[11];
  p.H = H; p.KV = KV; p.Sq = Sq; p.Sk = Sk;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_d<64>(p, B, dtype_bf16, s);
    case 128: return launch_d<128>(p, B, dtype_bf16, s);
    case 256: return launch_d<256>(p, B, dtype_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
