// Decode attention for Hopper (sm_90a): one query a sequence against the
// live keys of its KV cache, split over the keys.
//
// Replaces no TPU kernel.  The JAX package's decode attention is jnp
// (src/repro/models/attention.py:192, decode_attention): two einsums over
// the whole cache, a mask of the positions past the one written (and
// before a sliding window), and a softmax.  On the card that plain path
// copied the whole cache into the einsums' layouts every layer, scored all
// Smax positions and read a NEG_INF scalar from the host every layer; this
// kernel takes its place for tensors on the card.
//
// What it computes, for each sequence b and query head h (KV head
// kvh = h / G, G = H / KV):
//   s_j = (q . k_j) * scale, then softcap * tanh(s_j / softcap) if a softcap
//   is set, for the live keys j = lo..pos only (lo = max(0, pos - window + 1)
//   with a sliding window, else 0); out = sum_j p_j v_j / sum_j p_j with
//   p_j = exp(s_j - max s).  The plain version masks the other keys with
//   NEG_INF, which adds exp(NEG_INF - m) = 0 exactly: leaving them out is
//   the same sum.  Scores, the softmax's max and sum and the output's sums
//   are fp32 (the plain version rounds the scores to the compute dtype);
//   the output is rounded to the input dtype once.  bf16 rounds p to bf16
//   as the tensor cores' operand, as the plain version rounds its
//   probabilities and the flash kernel its p.
//
// What bounds it on an H100 SXM: bytes.  Each live key costs one K row and
// one V row (2 * D bytes each in bf16) and G * D multiply-adds for each of
// the two products, so at grok-1's G = 6 it does 3 flops a byte.  grok-1's
// decode shape (B 32, KV 8, D 128) at a full cache of 8,192 keys reads
// 1.07 GB a layer: 0.32 ms at 3.35 TB/s.  What the design does about it:
//   * the cache is read where it lies ([B, Smax, KV, D], any strides with a
//     contiguous D), so no layout copy comes first; each lane reads whole
//     16-byte pieces of rows, neighbouring lanes neighbouring pieces;
//   * only keys lo..pos are read;
//   * the G query heads of a KV head share each K and V row: a block owns
//     one (split, kvh, b) and computes all G heads from one read of a row;
//   * split-KV: when B * KV blocks alone would leave the SMs without
//     enough loads in flight, the wrapper splits the live keys into nsplit
//     contiguous chunks (decode_attention.py's `splits`, from B * KV, the
//     live length and the SM count); each block writes its fp32 partial
//     (m, l, acc) and a second small kernel sums the partials in split
//     order, so the result does not depend on scheduling.  With one split
//     the block writes the output itself and the second kernel is not
//     launched;
//   * so that the arithmetic does not become the limit instead (on CUDA
//     cores the two products, the shuffles that sum a dot product across
//     lanes and tanh took about 200 warp instructions a key row, which
//     measured 2.8 times the bytes bound at grok's full cache), bf16 runs
//     both products on the tensor cores (mma.sync m16n8k16, fp32 sums):
//     about 2 products a key row and no shuffles for the dot products.
//
// bf16 (decode_attention_mma_kernel, D = 16, 128, 256; G in 1..8 at run
// time): 4 warps a block, each warp walks tiles of 16 keys of its split.
// Lane (r = lane / 4, c = lane % 4):
//   S = Q K^T (rows: the G query heads, padded to 16 with zero rows; n8
//     tiles of keys t..t+7 and t+8..t+15; k16 steps over D): the lane's Q
//     fragment is row r's dims [c * D/4, c * D/4 + D/4), loaded once; its K
//     fragment is rows t + r and t + 8 + r, the same dims, D / 2 contiguous
//     bytes each.  The dims of a k-step are permuted (step kd takes the
//     lane's dims 4 kd .. 4 kd + 3) alike in Q and K, which leaves the dot
//     products as they are.
//   Online softmax on S's fragments: lane (r, c) holds row r's scores at
//     keys t + 2c, t + 2c + 1, t + 8 + 2c, t + 9 + 2c; the row's max takes
//     two shuffles; exponentials are ex2.approx in log2 units.
//   O^T += V^T P^T (rows: D dims in m16 tiles; n8 = the query heads; one
//     k16 step over the 16 keys): P^T's fragment is the lane's own four p
//     (packed to bf16), so S's layout feeds the product unchanged; V^T's
//     fragment is the lane's dims [r * D/8, r * D/8 + D/8) of its four keys'
//     rows, each pair of keys' values at one dim packed into a register
//     by byte permutes (m-tile mt, row r takes dim r * D/8 + 2 mt, row
//     r + 8 the next).  The output's columns are the query heads, so no
//     row of the product is padding.
// fp32 (decode_attention_fma_kernel, D = 16, 128, 256; G in 1..8 as a
// template argument): fp32 FMAs on CUDA cores.  A key row is read by kLanes
// lanes (16 bytes each: D = 128 takes 32 lanes, D = 16 four); a warp takes
// U rows a lane group per step (all loads issued before any use); the dot
// products are summed over the row's lanes by shuffles; each lane group
// keeps its own online softmax (exp2f, tanhf).  fp32 serves the .smoke()
// configs and the tests, not a deployment.
// Both merge the warps' states through shared memory in warp order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;          // query heads a KV head, at most
constexpr int kTile = 16;             // keys a warp takes a step (bf16)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;      // elements in 16 bytes
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static float pack(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static __nv_bfloat16 pack(float x) {
    return __float2bfloat16_rn(x);
  }
};

// How a warp of the fp32 kernel reads rows of D elements.
template <int D>
struct Rows {
  static constexpr int kVec = Elem<float>::kVec;
  static constexpr int kLanes = D / kVec < 32 ? D / kVec : 32;  // a row
  static constexpr int kE = D / kLanes;                          // a lane
  static constexpr int kNv = kE / kVec;          // 16-byte loads a lane
  static constexpr int kKeys = 32 / kLanes;      // rows a warp at once
  static_assert(kE % kVec == 0 && kLanes * kE == D, "unsupported D");
};

struct Params {
  const void* q;       // [B, KV, G, D] view (strides q_b, q_k, q_g)
  const void* k;       // [B, Smax, KV, D] views
  const void* v;
  void* o;             // [B, KV * G, D], contiguous
  float* acc;          // nsplit > 1: [B * H, nsplit, D] partial sums
  float* ml;           // nsplit > 1: [B * H, nsplit, 2] (max, sum)
  int64_t q_b, q_k, q_g, k_b, k_s, k_h, v_b, v_s, v_h;
  int KV, lo, L, chunk, nsplit;
  float scale, softcap;
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// NW 32-bit words from p (16-, 8- or 4-byte loads), or zeros when !live.
template <int NW>
__device__ __forceinline__ void load_words(const void* p, bool live,
                                           uint32_t (&w)[NW]) {
  if (!live) {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0u;
    return;
  }
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else {
    static_assert(NW == 1, "unsupported row piece");
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a b: m16n8k16, bf16 operands, fp32 sums.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The warps' states (s_ml[w][g] = max in log2 units and sum, s_acc[w][g][d]
// the unnormalised output; rows of GS query heads) merged in warp order:
// the block's output rows (one split) or its split's partials.
template <typename T, int D, int GS>
__device__ __forceinline__ void finish_block(const Params& p, int G, int b,
                                             int kvh, int split,
                                             float (*s_acc)[GS][D],
                                             float (*s_ml)[GS][2]) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_ml[w][g][0]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = s_ml[w][g][0];
      if (mw == -INFINITY) continue;             // a warp with no keys
      const float f = exp2f(mw - mx);
      sum += s_ml[w][g][1] * f;
      a += s_acc[w][g][d] * f;
    }
    const int64_t row = ((int64_t)b * p.KV + kvh) * G + g;
    if (p.nsplit == 1) {
      static_cast<T*>(p.o)[row * D + d] = Elem<T>::pack(a / sum);
    } else {
      const int64_t at = row * p.nsplit + split;
      p.acc[at * D + d] = a;
      if (d == 0) {
        p.ml[at * 2] = mx;
        p.ml[at * 2 + 1] = sum;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_mma_kernel(const Params p, int G) {
  constexpr int KW = D / 8;     // words of a lane's K piece (D / 4 dims)
  constexpr int VW = D / 16;    // words of a lane's V piece; m-tiles of O^T
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, c = lane & 3;
  const int begin = p.lo + split * p.chunk;
  const int end = min(p.lo + p.L, begin + p.chunk);   // exclusive

  // Q's fragment: row r (zero past G), dims [c * D/4, c * D/4 + D/4)
  uint32_t qf[KW];
  load_words<KW>(static_cast<const __nv_bfloat16*>(p.q) + b * p.q_b +
                     kvh * p.q_k + (int64_t)r * p.q_g + c * (D / 4),
                 r < G, qf);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_b + kvh * p.k_h + c * (D / 4);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_b + kvh * p.v_h + r * (D / 8);
  const float cap = p.softcap;
  // scores in log2 units: without a softcap one multiply
  const float to_log2 = cap > 0.f ? p.scale : p.scale * kLog2e;
  const float cap_in = cap > 0.f ? 2.f * kLog2e / cap : 0.f;
  const float cap_out = 2.f * cap * kLog2e;

  float m = -INFINITY;          // row r's running max, log2 units
  float l = 0.f;                // this lane's share of row r's sum
  float o[VW][4];  // O^T: dims r * D/8 + 2 mt (and + 1), heads 2c and 2c + 1
#pragma unroll
  for (int mt = 0; mt < VW; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[mt][i] = 0.f;

  for (int t = begin + warp * kTile; t < end; t += kWarps * kTile) {
    uint32_t k0[KW], k1[KW], vr[4][VW];
    load_words<KW>(kp + (int64_t)(t + r) * p.k_s, t + r < end, k0);
    load_words<KW>(kp + (int64_t)(t + 8 + r) * p.k_s, t + 8 + r < end, k1);
    const int key[4] = {t + 2 * c, t + 2 * c + 1, t + 8 + 2 * c,
                        t + 9 + 2 * c};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_words<VW>(vp + (int64_t)key[i] * p.v_s, key[i] < end, vr[i]);

    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      mma(s0, qf[2 * kd], 0u, qf[2 * kd + 1], 0u, k0[2 * kd], k0[2 * kd + 1]);
      mma(s1, qf[2 * kd], 0u, qf[2 * kd + 1], 0u, k1[2 * kd], k1[2 * kd + 1]);
    }
    float s[4] = {s0[0], s0[1], s1[0], s1[1]};   // row r at key[0..3]
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[i] * to_log2;
      // cap * tanh(x / cap) = cap - 2 cap / (exp(2 x / cap) + 1)
      if (cap > 0.f)
        x = cap * kLog2e -
            __fdividef(cap_out, ex2(fminf(x * cap_in, 64.f)) + 1.f);
      s[i] = key[i] < end ? x : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);               // finite: key t is live
    const float corr = ex2(m - mn);              // 0 while m is -inf
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = ex2(s[i] - mn);
    l = l * corr + ((pr[0] + pr[1]) + (pr[2] + pr[3]));
    m = mn;
    // O^T's columns 2c and 2c + 1 are rows 2c and 2c + 1 of S
    const float c_lo = __shfl_sync(0xffffffffu, corr, 8 * c);
    const float c_hi = __shfl_sync(0xffffffffu, corr, 8 * c + 4);
    const uint32_t p0 = pack_bf16(pr[0], pr[1]), p1 = pack_bf16(pr[2], pr[3]);
#pragma unroll
    for (int mt = 0; mt < VW; ++mt) {
      o[mt][0] *= c_lo;
      o[mt][1] *= c_hi;
      o[mt][2] *= c_lo;
      o[mt][3] *= c_hi;
      mma(o[mt], __byte_perm(vr[0][mt], vr[1][mt], 0x5410),
          __byte_perm(vr[0][mt], vr[1][mt], 0x7632),
          __byte_perm(vr[2][mt], vr[3][mt], 0x5410),
          __byte_perm(vr[2][mt], vr[3][mt], 0x7632), p0, p1);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  __shared__ float s_acc[kWarps][kMaxGroup][D];
  __shared__ float s_ml[kWarps][kMaxGroup][2];
  if (c == 0 && r < G) {
    s_ml[warp][r][0] = m;
    s_ml[warp][r][1] = l;
  }
#pragma unroll
  for (int mt = 0; mt < VW; ++mt) {
    const int d = r * (D / 8) + 2 * mt;
    if (2 * c < G) {
      s_acc[warp][2 * c][d] = o[mt][0];
      s_acc[warp][2 * c][d + 1] = o[mt][2];
    }
    if (2 * c + 1 < G) {
      s_acc[warp][2 * c + 1][d] = o[mt][1];
      s_acc[warp][2 * c + 1][d + 1] = o[mt][3];
    }
  }
  __syncthreads();
  finish_block<__nv_bfloat16, D, kMaxGroup>(p, G, b, kvh, split, s_acc, s_ml);
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_fma_kernel(const Params p) {
  using R = Rows<D>;
  constexpr int E = R::kE, NV = R::kNv, VEC = R::kVec;
  constexpr int LANES = R::kLanes, KEYS = R::kKeys;
  // rows a lane group reads a step: fewer where G * E registers each of
  // queries and accumulators leave little room
  constexpr int U = G * E <= 32 ? 4 : 2;
  constexpr int STEP = KEYS * U;                 // keys a warp a step

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LANES, col = (lane % LANES) * E;
  const int begin = p.lo + split * p.chunk;
  const int end = min(p.lo + p.L, begin + p.chunk);   // exclusive

  float q[G][E];
  const float* qp = static_cast<const float*>(p.q) + b * p.q_b +
                    kvh * p.q_k + col;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int n = 0; n < NV; ++n)
      Elem<float>::unpack(load16(qp + g * p.q_g + n * VEC), &q[g][n * VEC]);

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const float* kp = static_cast<const float*>(p.k) + b * p.k_b +
                    kvh * p.k_h + col;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_b +
                    kvh * p.v_h + col;
  const float scale = p.scale, cap = p.softcap;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;

  for (int t = begin + warp * STEP; t < end; t += kWarps * STEP) {
    uint4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = t + u * KEYS + sub;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (j < end) {
          kr[u][n] = load16(kp + (int64_t)j * p.k_s + n * VEC);
          vr[u][n] = load16(vp + (int64_t)j * p.v_s + n * VEC);
        } else {
          kr[u][n] = make_uint4(0, 0, 0, 0);
          vr[u][n] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    float s[U][G];                               // scores, log2 units
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int n = 0; n < NV; ++n)
        Elem<float>::unpack(kr[u][n], &kf[n * VEC]);
      const bool live = t + u * KEYS + sub < end;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(q[g][e], kf[e], d);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        d *= scale;
        if (cap > 0.f) d = cap * tanhf(d * inv_cap);
        s[u][g] = live ? d * kLog2e : -INFINITY;
      }
    }
    float vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NV; ++n)
        Elem<float>::unpack(vr[u][n], &vf[u][n * VEC]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mt = fmaxf(mt, s[u][g]);
      if (mt == -INFINITY) continue;             // no live key yet
      const float corr = exp2f(m[g] - mt);       // 0 while m is -inf
      float pu[U], ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pu[u] = exp2f(s[u][g] - mt);
        ps += pu[u];
      }
      l[g] = l[g] * corr + ps;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(pu[u], vf[u][e], a);
        acc[g][e] = a;
      }
      m[g] = mt;
    }
  }

  // the lane groups of the warp, merged in order of their lane bits
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lw = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = m[g] == -INFINITY ? 0.f : exp2f(m[g] - mn);
      const float cw = mo == -INFINITY ? 0.f : exp2f(mo - mn);
      l[g] = l[g] * a + lw * cw;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], off) * cw;
      m[g] = mn;
    }
  }

  __shared__ float s_acc[kWarps][G][D];
  __shared__ float s_ml[kWarps][G][2];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) s_acc[warp][g][col + e] = acc[g][e];
      if (lane == 0) {
        s_ml[warp][g][0] = m[g];
        s_ml[warp][g][1] = l[g];
      }
    }
  }
  __syncthreads();
  finish_block<float, D, G>(p, G, b, kvh, split, s_acc, s_ml);
}

// Sums the splits' partials of one (b, h) row in split order.  Every split
// holds at least one live key, so every partial max is finite.
template <typename T>
__global__ void decode_attention_combine_kernel(const float* acc,
                                                const float* ml, int nsplit,
                                                int D, T* o) {
  const int64_t row = blockIdx.x;
  const float* mrow = ml + row * nsplit * 2;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, mrow[2 * s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float f = exp2f(mrow[2 * s] - mx);
      sum += mrow[2 * s + 1] * f;
      a += acc[(row * nsplit + s) * D + d] * f;
    }
    o[row * D + d] = Elem<T>::pack(a / sum);
  }
}

// The launch's error, then (nsplit > 1) the combine kernel's.
template <typename T>
cudaError_t combine(const Params& p, int B, int G, int D,
                    cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  decode_attention_combine_kernel<T><<<(unsigned)(B * p.KV * G), D, 0,
                                       stream>>>(p.acc, p.ml, p.nsplit, D,
                                                 static_cast<T*>(p.o));
  return cudaGetLastError();
}

template <int D, int G>
void launch_fma_group(const Params& p, dim3 grid, cudaStream_t stream) {
  decode_attention_fma_kernel<D, G><<<grid, kThreads, 0, stream>>>(p);
}

template <int D>
cudaError_t launch_fma(const Params& p, int B, int G, cudaStream_t stream) {
  const dim3 grid(p.nsplit, p.KV, B);
  switch (G) {
    case 1: launch_fma_group<D, 1>(p, grid, stream); break;
    case 2: launch_fma_group<D, 2>(p, grid, stream); break;
    case 3: launch_fma_group<D, 3>(p, grid, stream); break;
    case 4: launch_fma_group<D, 4>(p, grid, stream); break;
    case 5: launch_fma_group<D, 5>(p, grid, stream); break;
    case 6: launch_fma_group<D, 6>(p, grid, stream); break;
    case 7: launch_fma_group<D, 7>(p, grid, stream); break;
    case 8: launch_fma_group<D, 8>(p, grid, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return combine<float>(p, B, G, D, stream);
}

template <int D>
cudaError_t launch_mma(const Params& p, int B, int G, cudaStream_t stream) {
  const dim3 grid(p.nsplit, p.KV, B);
  decode_attention_mma_kernel<D><<<grid, kThreads, 0, stream>>>(p, G);
  return combine<__nv_bfloat16>(p, B, G, D, stream);
}

template <int D>
cudaError_t launch_dim(const Params& p, int B, int G, int bf16,
                       cudaStream_t stream) {
  return bf16 ? launch_mma<D>(p, B, G, stream)
              : launch_fma<D>(p, B, G, stream);
}

}  // namespace

// One decode step's attention: q [B, KV, G, D] (strides[0..2]: batch, KV
// head, query head of the group), k and v [B, Smax, KV, D] (strides[3..5]
// and [6..8]: batch, position, KV head), D contiguous everywhere, every
// view 16-byte aligned; out [B, KV, G, D] contiguous.  G in 1..8, D in
// {16, 128, 256}; dtype_bf16 1 for bf16, 0 for fp32 (all four tensors).
// Keys lo .. lo + L - 1 are read, in nsplit chunks of `chunk` (every chunk
// non-empty); with nsplit > 1, scratch is fp32 of B * KV * G * nsplit *
// (D + 2) elements.  Launches on `stream` and returns the CUDA error (0
// when the launches were accepted); an unsupported shape returns
// cudaErrorInvalidValue.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* scratch,
    int B, int KV, int G, int D, const int64_t* strides, int lo, int L,
    int chunk, int nsplit, float scale, float softcap, int dtype_bf16,
    void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > kMaxGroup || L <= 0 ||
      nsplit <= 0 || chunk <= 0 || (int64_t)chunk * (nsplit - 1) >= L ||
      (int64_t)chunk * nsplit < L || (nsplit > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.acc = static_cast<float*>(scratch);
  p.ml = nsplit > 1 ? p.acc + (int64_t)B * KV * G * nsplit * D : nullptr;
  p.q_b = strides[0];
  p.q_k = strides[1];
  p.q_g = strides[2];
  p.k_b = strides[3];
  p.k_s = strides[4];
  p.k_h = strides[5];
  p.v_b = strides[6];
  p.v_s = strides[7];
  p.v_h = strides[8];
  p.KV = KV;
  p.lo = lo;
  p.L = L;
  p.chunk = chunk;
  p.nsplit = nsplit;
  p.scale = scale;
  p.softcap = softcap;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return (int)launch_dim<16>(p, B, G, dtype_bf16, s);
    case 128: return (int)launch_dim<128>(p, B, G, dtype_bf16, s);
    case 256: return (int)launch_dim<256>(p, B, G, dtype_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
