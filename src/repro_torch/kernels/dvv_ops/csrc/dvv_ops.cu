// Dotted-version-vector dominance kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dvv_ops/dvv_ops.py:
//   dvv_sync_mask_tiled_kernel, dvv_sync_mask_kernel
//                         <- dvv_sync_mask_pallas (_sync_mask_kernel)
//   dvv_read_sweep_tiled_kernel, dvv_read_sweep_kernel
//                         <- ops.dvv_read_sweep (dvv_sync_mask_pallas
//                            followed by core.batched.merge_context)
//   dvv_leq_kernel        <- dvv_leq_pallas (_leq_kernel)
//
// Encoding (core/batched.py): a clock is vv int32[R], a dot column
// dot_id (-1 = NO_DOT) and the dot's counter dot_n.  x <= y (history(x) is a
// subset of history(y)) holds iff every column is covered,
//     vx[r] <= vy[r]  or  (iy == r and vx[r] == ny == vy[r] + 1),
// and x's dot is covered,  nx <= vy[ix]  or  (iy == ix and nx == ny).
// Slot x of a key survives sync iff it is valid, no valid y strictly
// dominates it, and no valid y at a lower slot equals it.
//
// What bounds these kernels on an H100 SXM (3.35 TB/s, 132 SMs with 64
// int32 lanes each, about 16.7 Tops/s of int32 at the 1.98 GHz boost clock):
//   * bytes: the sweep reads N*K*(4R + 9) bytes (vv, dot_id, dot_n, valid)
//     and writes N*K mask bytes (plus N*R*8 ceiling bytes for the read
//     sweep).  At [1048576, 8, 8] that is 344 MB + 8 MB: about 105 us.
//   * operations: survival compares every valid pair of a key's K slots in
//     both directions over R columns, about 2*K*(K-1)*R*c int32 operations
//     per key (c ~ 2: one compare and one fold per column).  At
//     [1048576, 8, 8] that is about 1.8 Gops: about 110 us.
//   The store's own calls are small ([N <= 8192, K <= 4, R <= 8]), so
//   there a call costs a launch and one trip to device memory, and the
//   host's work around it (front end, ops.py) decides the time.
//
// The tiled path (dvv_*_tiled_kernel; K and R in 1..8, 16-byte aligned
// arrays; dvv_ops.py's tiled_path chooses) has two bodies over one per-key
// sweep.  Up to 16,384 keys (every call the store makes today: one per
// shard and quorum group) one thread a key reads its clocks straight from
// device memory (sweep_direct).  Larger calls are staged (sweep_tiled):
// chip_smoke.py's 1M-key row, and the calls of the segmented sweep that
// will fold a whole plane call into one launch (ROADMAP).  The staged body:
//   * a block owns tiles of T = 32 or 64 consecutive keys (one thread a
//     key), walked grid-stride by a grid sized to the SMs' occupancy; each
//     tile's contiguous slabs of vv, dot_id, dot_n and valid land in a
//     shared-memory stage by cp.async in 16-byte pieces (coalesced; the
//     ragged end zero-filled);
//   * the stage is repacked into one record a key (vv, ids, counters,
//     valid) at an odd pitch, so that 32 threads reading the same word of
//     32 keys hit 32 banks; the next tile then lands in the stage while
//     this one is computed from the records (a ring of two).
// Both bodies share the per-key sweep (sweep_key):
//   * each thread holds its key's K clocks in registers (K and R padded to
//     compile-time bounds KMAX and RMAX with zero columns, which change no
//     compare); the dot-extends term is folded once a clock into a "cover"
//     vector (vy[iy] + 1 where ny == vy[iy] + 1), so x <= y on the columns
//     is vx[r] <= cover_y[r] for all r: one compare a column and
//     direction, each unordered pair once with both directions from one
//     pass, without branches;
//   * survival bits fold in a register, and the K mask bytes (one 2-, 4-
//     or 8-byte store) and the ceilings of the survivors (from the same
//     registers) go straight to device memory, neighbouring threads on
//     neighbouring keys.
// The general path (dvv_sync_mask_kernel, dvv_read_sweep_kernel: one
// thread per (key, slot) walking the other slots from device memory) takes
// every other shape (K up to any size, R = 0, unaligned views); it is the
// first design of these kernels.  One C function, sweep_launch, picks the
// kernel and its launch shape for both entry points (a sweep on device
// tensors, and the front end's staged sweep from host memory).
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

#define NO_DOT (-1)

namespace {

__device__ __forceinline__ bool dvv_leq(const int32_t* __restrict__ vx,
                                        int32_t ix, int32_t nx,
                                        const int32_t* __restrict__ vy,
                                        int32_t iy, int32_t ny, int R) {
  if (R == 0) return true;  // empty universe: all histories are empty
  for (int r = 0; r < R; ++r) {
    const int32_t a = vx[r];
    const int32_t b = vy[r];
    // b + 1 in unsigned arithmetic wraps like the int32 tensors do.
    const bool dot_extends = iy == r && a == ny &&
                             (uint32_t)a == (uint32_t)b + 1u;
    if (!(a <= b || dot_extends)) return false;
  }
  if (ix == NO_DOT) return true;
  const int col = ix < 0 ? 0 : (ix >= R ? R - 1 : ix);
  return nx <= vy[col] || (iy == ix && nx == ny);
}

// Does slot x of one key survive sync?  It must be valid, no other valid y
// may strictly dominate it, and no valid y at a lower slot may equal it
// (duplicates keep the earliest slot).
__device__ __forceinline__ bool dvv_survives(const int32_t* __restrict__ vv,
                                             const int32_t* __restrict__ ids,
                                             const int32_t* __restrict__ ns,
                                             const uint8_t* __restrict__ valid,
                                             int x, int K, int R) {
  if (!valid[x]) return false;
  const int32_t* vx = vv + (int64_t)x * R;
  const int32_t ix = ids[x], nx = ns[x];
  for (int y = 0; y < K; ++y) {
    if (y == x || !valid[y]) continue;
    const int32_t* vy = vv + (int64_t)y * R;
    const int32_t iy = ids[y], ny = ns[y];
    if (!dvv_leq(vx, ix, nx, vy, iy, ny, R)) continue;
    // x <= y: x dies if y is strictly above it, or equal and earlier.
    if (y < x || !dvv_leq(vy, iy, ny, vx, ix, nx, R)) return false;
  }
  return true;
}

__global__ void dvv_sync_mask_kernel(const int32_t* __restrict__ vvs,
                                     const int32_t* __restrict__ ids,
                                     const int32_t* __restrict__ ns,
                                     const uint8_t* __restrict__ valid,
                                     uint8_t* __restrict__ out,
                                     int64_t N, int K, int R) {
  const int64_t total = N * K;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t n = t / K;
    const int x = (int)(t - n * K);
    out[t] = dvv_survives(vvs + n * K * R, ids + n * K, ns + n * K,
                          valid + n * K, x, K, R);
  }
}

// One block owns `kpb` consecutive keys.  Its threads first decide the
// survival of every (key, slot) into shared memory, then fold the
// survivors' effective vectors (the dot folded in at its column) into the
// per-key ceiling, so the mask is never re-read from device memory.
__global__ void dvv_read_sweep_kernel(const int32_t* __restrict__ vvs,
                                      const int32_t* __restrict__ ids,
                                      const int32_t* __restrict__ ns,
                                      const uint8_t* __restrict__ valid,
                                      uint8_t* __restrict__ mask,
                                      int64_t* __restrict__ ceil,
                                      int64_t N, int K, int R, int kpb) {
  extern __shared__ uint8_t smask[];
  const int64_t key0 = (int64_t)blockIdx.x * kpb;
  const int nk = N - key0 < kpb ? (int)(N - key0) : kpb;
  for (int t = threadIdx.x; t < nk * K; t += blockDim.x) {
    const int64_t n = key0 + t / K;
    const int x = t % K;
    const uint8_t m = dvv_survives(vvs + n * K * R, ids + n * K, ns + n * K,
                                   valid + n * K, x, K, R);
    smask[t] = m;
    mask[n * K + x] = m;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nk * R; t += blockDim.x) {
    const int k = t / R;
    const int r = t % R;
    const int64_t n = key0 + k;
    // Rows that did not survive count as 0, as merge_context masks them.
    int32_t top = INT_MIN;
    for (int x = 0; x < K; ++x) {
      int32_t v = 0;
      if (smask[k * K + x]) {
        v = vvs[(n * K + x) * R + r];
        if (ids[n * K + x] == r) v = max(v, ns[n * K + x]);
      }
      top = max(top, v);
    }
    ceil[n * R + r] = top;
  }
}

__global__ void dvv_leq_kernel(const int32_t* __restrict__ vx,
                               const int32_t* __restrict__ ix,
                               const int32_t* __restrict__ nx,
                               const int32_t* __restrict__ vy,
                               const int32_t* __restrict__ iy,
                               const int32_t* __restrict__ ny,
                               uint8_t* __restrict__ out, int64_t N, int R) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    out[n] = dvv_leq(vx + n * R, ix[n], nx[n], vy + n * R, iy[n], ny[n], R);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;  // grid-stride beyond this

int grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

constexpr int kMaxSharedKeys = 48 * 1024;  // the general read sweep's
                                            // static shared-memory limit

// ---------------------------------------------------------------------------
// The tiled path
// ---------------------------------------------------------------------------

// cp.async of one 16-byte piece (both addresses 16-byte aligned) that reads
// n <= 16 bytes of src and zero-fills the rest; the commit and the wait for
// all but the newest N groups of this thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  const uint32_t saddr = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start an asynchronous copy of `bytes` bytes from global `src` to shared
// `dst` (both 16-byte aligned) in 16-byte pieces spread over the block's
// threads; the last piece reads only what is left and zero-fills the rest.
__device__ __forceinline__ void stage_async(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes) {
  for (int c = threadIdx.x * 16; c < bytes; c += blockDim.x * 16)
    cp_async16(dst + c, src + c, bytes - c < 16 ? bytes - c : 16);
}

// The shared memory of a block whose tiles hold T keys: the stage a tile's
// slabs land in (vv, ids, ns, valid, each 16-byte aligned), and the records
// the stage is repacked into, one a key ([vv K*R | ids K | ns K | valid K]
// as words, at an odd pitch so that the same word of 32 keys lies in 32
// banks).  The next tile lands in the stage while this one is computed from
// the records: a ring of two.
struct TileLayout {
  int vv, ids, ns, valid, rec, pitch, ceil, total;  // bytes; words (pitch)
  __host__ __device__ TileLayout(int T, int K, int R) {
    vv = 0;
    ids = vv + round16(T * K * R * 4);
    ns = ids + round16(T * K * 4);
    valid = ns + round16(T * K * 4);
    rec = valid + round16(T * K);
    pitch = (K * R + 3 * K) | 1;
    ceil = rec + round16(T * pitch * 4);  // the warps' ceilings (read sweep)
    total = ceil + T * R * 8;
  }
  __host__ __device__ static int round16(int b) { return (b + 15) & ~15; }
};

// Copy the n elements of a staged slab of rows of `width` into column col0
// onwards of the records.  Element w = tid + i T sits at row w / width,
// column w % width; stepping by T adds T / width rows and T % width columns.
template <typename Src>
__device__ __forceinline__ void repack(const Src* __restrict__ src, int n,
                                       int width, int32_t* __restrict__ rec,
                                       int pitch, int col0) {
  const int T = blockDim.x;
  int row = threadIdx.x / width, col = threadIdx.x % width;
  const int drow = T / width, dcol = T % width;
#pragma unroll 4
  for (int w = threadIdx.x; w < n; w += T) {
    rec[row * pitch + col0 + col] = (int32_t)src[w];
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
}

// Sweep one key whose clocks are vrow[x * R + r], dot ids idp[x],
// counters cnp[x] and validity okp[x] (in shared or device memory): store
// its K mask bytes, and write its R ceilings to crow (this thread's row of
// its warp's scratch in shared memory, stored by warp_store).
template <int KMAX, int RMAX, bool kCeil, typename Flag>
__device__ __forceinline__ void sweep_key(const int32_t* vrow,
                                          const int32_t* idp,
                                          const int32_t* cnp,
                                          const Flag* okp, int K, int R,
                                          int64_t key,
                                          uint8_t* __restrict__ mask,
                                          int64_t* __restrict__ crow) {
  // the key's K clocks in registers (slots past K and columns past R are
  // zeros and never decide anything)
  int32_t v[KMAX][RMAX], cov[KMAX][RMAX], id[KMAX], cn[KMAX];
  bool ok[KMAX];
#pragma unroll
  for (int x = 0; x < KMAX; ++x) {
    const bool in = x < K;
    id[x] = in ? idp[x] : NO_DOT;
    cn[x] = in ? cnp[x] : 0;
    ok[x] = in && okp[x] != 0;
    // the dot covers one more event at its own column when it extends the
    // range there: cover = vv + 1 at that column
    int ext = -1;
    if (in && id[x] >= 0 && id[x] < R) {
      const int32_t a = vrow[x * R + id[x]];
      if (a != INT_MAX && cn[x] == a + 1) ext = id[x];
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int32_t a = in && r < R ? vrow[x * R + r] : 0;
      v[x][r] = a;
      cov[x][r] = a + (r == ext);
    }
  }
  // each unordered pair once, both directions from one pass
  uint32_t killed = 0;
#pragma unroll
  for (int x = 0; x < KMAX; ++x) {
    if (x >= K) break;
#pragma unroll
    for (int y = x + 1; y < KMAX; ++y) {
      if (y >= K) break;
      bool le = true, ge = true;         // x <= y, y <= x
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        le &= v[x][r] <= cov[y][r];
        ge &= v[y][r] <= cov[x][r];
      }
      const int cx = id[x] < 0 ? 0 : (id[x] >= R ? R - 1 : id[x]);
      const int cy = id[y] < 0 ? 0 : (id[y] >= R ? R - 1 : id[y]);
      const bool same = id[x] == id[y] && cn[x] == cn[y];
      le &= id[x] == NO_DOT || cn[x] <= vrow[y * R + cx] || same;
      ge &= id[y] == NO_DOT || cn[y] <= vrow[x * R + cy] || same;
      const bool both = ok[x] && ok[y];
      killed |= (uint32_t)(both && le && !ge) << x;  // y strictly above
      killed |= (uint32_t)(both && ge) << y;    // x above, or equal and first
    }
  }
  uint64_t bits = 0;                     // the mask's K bytes
#pragma unroll
  for (int x = 0; x < KMAX; ++x)
    bits |= (uint64_t)(x < K && ok[x] && !((killed >> x) & 1u)) << (8 * x);
  uint8_t* out = mask + key * K;         // aligned to K where K is 2, 4, 8
  if (K == 8) {
    *reinterpret_cast<uint64_t*>(out) = bits;
  } else if (K == 4) {
    *reinterpret_cast<uint32_t*>(out) = (uint32_t)bits;
  } else if (K == 2) {
    *reinterpret_cast<uint16_t*>(out) = (uint16_t)bits;
  } else {
    for (int x = 0; x < K; ++x) out[x] = (uint8_t)(bits >> (8 * x));
  }
  if constexpr (kCeil) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= R) break;
      // rows that did not survive count as 0, as merge_context masks them
      int32_t top = INT_MIN;
#pragma unroll
      for (int x = 0; x < KMAX; ++x) {
        if (x >= K) break;
        int32_t e = v[x][r];
        if (id[x] == r) e = max(e, cn[x]);
        top = max(top, (bits >> (8 * x)) & 1u ? e : 0);
      }
      crow[r] = top;
    }
  }
}

// A warp's n ceilings, staged row by row in shared memory (src), out to
// their contiguous place in device memory (dst, 16-byte aligned) in 16-byte
// pieces, neighbouring lanes on neighbouring pieces.
__device__ __forceinline__ void warp_store(int64_t* __restrict__ dst,
                                           const int64_t* __restrict__ src,
                                           int n) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < n / 2; c += 32)
    reinterpret_cast<int4*>(dst)[c] = reinterpret_cast<const int4*>(src)[c];
  if ((n & 1) && lane == 0) dst[n - 1] = src[n - 1];
}

template <int KMAX, int RMAX, bool kCeil>
__device__ __forceinline__ void sweep_tiled(const int32_t* __restrict__ vvs,
                                            const int32_t* __restrict__ ids,
                                            const int32_t* __restrict__ ns,
                                            const uint8_t* __restrict__ valid,
                                            uint8_t* __restrict__ mask,
                                            int64_t* __restrict__ ceil,
                                            int64_t N, int K, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const TileLayout L(T, K, R);
  const int KR = K * R, P = L.pitch;
  int32_t* rec = reinterpret_cast<int32_t*>(smem + L.rec);
  const int64_t ntiles = (N + T - 1) / T;

  auto load = [&](int64_t tile) {
    const int64_t k0 = tile * T;
    const int nk = (int)(N - k0 < T ? N - k0 : T);
    stage_async(smem + L.vv, (const unsigned char*)(vvs + k0 * KR),
                nk * KR * 4);
    stage_async(smem + L.ids, (const unsigned char*)(ids + k0 * K),
                nk * K * 4);
    stage_async(smem + L.ns, (const unsigned char*)(ns + k0 * K), nk * K * 4);
    stage_async(smem + L.valid, valid + k0 * K, nk * K);
    cp_async_commit();
  };

  int64_t tile = blockIdx.x;
  if (tile < ntiles) load(tile);
  for (; tile < ntiles; tile += gridDim.x) {
    const int64_t k0 = tile * T;
    const int nk = (int)(N - k0 < T ? N - k0 : T);
    cp_async_wait<0>();
    __syncthreads();               // the tile has landed, the records are free
    repack(reinterpret_cast<const int32_t*>(smem + L.vv), nk * KR, KR, rec,
           P, 0);
    repack(reinterpret_cast<const int32_t*>(smem + L.ids), nk * K, K, rec,
           P, KR);
    repack(reinterpret_cast<const int32_t*>(smem + L.ns), nk * K, K, rec, P,
           KR + K);
    repack(smem + L.valid, nk * K, K, rec, P, KR + 2 * K);
    __syncthreads();               // the records are whole, the stage free
    if (tile + gridDim.x < ntiles) load(tile + gridDim.x);
    int64_t* scratch = reinterpret_cast<int64_t*>(smem + L.ceil);
    if (tid < nk) {
      const int32_t* my = rec + tid * P;
      sweep_key<KMAX, RMAX, kCeil>(my, my + KR, my + KR + K,
                                   my + KR + 2 * K, K, R, k0 + tid, mask,
                                   scratch + tid * R);
    }
    if constexpr (kCeil) {
      const int w0 = tid & ~31;          // this warp's first key in the tile
      __syncwarp();
      if (w0 < nk)
        warp_store(ceil + (k0 + w0) * R, scratch + w0 * R,
                   (nk - w0 < 32 ? nk - w0 : 32) * R);
    }
  }
  cp_async_wait<0>();
}

// The same sweep without shared memory, for calls too small to fill the
// card: one thread a key reads its own clocks straight from device memory
// (one round trip instead of a stage, a repack and two barriers).
// Blocks are one warp.
template <int KMAX, int RMAX, bool kCeil>
__device__ __forceinline__ void sweep_direct(
    const int32_t* __restrict__ vvs, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ ns, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ mask, int64_t* __restrict__ ceil, int64_t N, int K,
    int R) {
  const int lane = threadIdx.x;
  if constexpr (!kCeil) {
    for (int64_t key = (int64_t)blockIdx.x * 32 + lane; key < N;
         key += (int64_t)gridDim.x * 32)
      sweep_key<KMAX, RMAX, false>(vvs + key * K * R, ids + key * K,
                                   ns + key * K, valid + key * K, K, R, key,
                                   mask, nullptr);
  } else {
    __shared__ __align__(16) int64_t scratch[32 * RMAX];
    for (int64_t base = (int64_t)blockIdx.x * 32; base < N;
         base += (int64_t)gridDim.x * 32) {
      const int64_t key = base + lane;
      if (key < N)
        sweep_key<KMAX, RMAX, true>(vvs + key * K * R, ids + key * K,
                                    ns + key * K, valid + key * K, K, R, key,
                                    mask, scratch + lane * R);
      __syncwarp();
      warp_store(ceil + base * R, scratch,
                 (int)(N - base < 32 ? N - base : 32) * R);
      __syncwarp();
    }
  }
}

// The two tiled kernels, named apart for the profiler's traces; kStaged
// picks the staged body or the direct one.
template <int KMAX, int RMAX, bool kStaged>
__global__ void __launch_bounds__(64)
dvv_sync_mask_tiled_kernel(const int32_t* __restrict__ vvs,
                           const int32_t* __restrict__ ids,
                           const int32_t* __restrict__ ns,
                           const uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ mask, int64_t* ceil,
                           int64_t N, int K, int R) {
  if constexpr (kStaged)
    sweep_tiled<KMAX, RMAX, false>(vvs, ids, ns, valid, mask, ceil, N, K, R);
  else
    sweep_direct<KMAX, RMAX, false>(vvs, ids, ns, valid, mask, ceil, N, K, R);
}

template <int KMAX, int RMAX, bool kStaged>
__global__ void __launch_bounds__(64)
dvv_read_sweep_tiled_kernel(const int32_t* __restrict__ vvs,
                            const int32_t* __restrict__ ids,
                            const int32_t* __restrict__ ns,
                            const uint8_t* __restrict__ valid,
                            uint8_t* __restrict__ mask, int64_t* ceil,
                            int64_t N, int K, int R) {
  if constexpr (kStaged)
    sweep_tiled<KMAX, RMAX, true>(vvs, ids, ns, valid, mask, ceil, N, K, R);
  else
    sweep_direct<KMAX, RMAX, true>(vvs, ids, ns, valid, mask, ceil, N, K, R);
}

// Calls of at most this many keys take the direct body: below it the
// staged body's barriers and repack cost more than its coalesced loads save
// (on an H100, PERF.md: direct 3.6 against staged 4.4 us at [8192, 4, 5],
// a tie at [16384, 4, 8], staged 5.8 against 7.5 us at [32768, 4, 8]).
constexpr int64_t kDirectMaxKeys = 16384;

template <int KMAX, int RMAX, bool kCeil>
int launch_tiled(const void* vvs, const void* ids, const void* ns,
                 const void* valid, void* mask, void* ceil, int64_t N, int K,
                 int R, cudaStream_t stream) {
  // per instance: the SMs, and the staged kernel's blocks an SM holds at
  // 32 and 64 keys a tile (the largest layout's shared memory is set once)
  static int sms = 0, per_sm[2] = {0, 0};
  auto staged = kCeil ? dvv_read_sweep_tiled_kernel<KMAX, RMAX, true>
                      : dvv_sync_mask_tiled_kernel<KMAX, RMAX, true>;
  auto direct = kCeil ? dvv_read_sweep_tiled_kernel<KMAX, RMAX, false>
                      : dvv_sync_mask_tiled_kernel<KMAX, RMAX, false>;
  if (!sms) {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t err = cudaFuncSetAttribute(
        staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TileLayout(64, KMAX, RMAX).total);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < 2; ++i) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[i], staged, 32 << i, TileLayout(32 << i, KMAX, RMAX).total);
      if (per_sm[i] < 1) per_sm[i] = 1;
    }
    if (count < 1) return (int)cudaErrorInvalidValue;
    sms = count;
  }
  if (N <= kDirectMaxKeys) {
    const int grid = (int)((N + 31) / 32);   // a warp a block: every SM
    direct<<<grid, 32, 0, stream>>>(
        (const int32_t*)vvs, (const int32_t*)ids, (const int32_t*)ns,
        (const uint8_t*)valid, (uint8_t*)mask, (int64_t*)ceil, N, K, R);
    return (int)cudaGetLastError();
  }
  // 32 keys a tile while every tile fits in one wave, else 64
  const int big = N > (int64_t)32 * sms * per_sm[0];
  const int T = 32 << big;
  const int64_t tiles = (N + T - 1) / T;
  const int64_t most = (int64_t)sms * per_sm[big];
  const int grid = (int)(tiles < most ? tiles : most);
  staged<<<grid, T, TileLayout(T, K, R).total, stream>>>(
      (const int32_t*)vvs, (const int32_t*)ids, (const int32_t*)ns,
      (const uint8_t*)valid, (uint8_t*)mask, (int64_t*)ceil, N, K, R);
  return (int)cudaGetLastError();
}

template <bool kCeil>
int launch_tiled_any(const void* vvs, const void* ids, const void* ns,
                     const void* valid, void* mask, void* ceil, int64_t N,
                     int K, int R, cudaStream_t s) {
  if (K < 1 || K > 8 || R < 1 || R > 8) return (int)cudaErrorInvalidValue;
#define DVV_TILED(KM, RM) \
  return launch_tiled<KM, RM, kCeil>(vvs, ids, ns, valid, mask, ceil, N, K, \
                                     R, s)
  if (R <= 4) {
    if (K <= 2) DVV_TILED(2, 4);
    if (K <= 4) DVV_TILED(4, 4);
    DVV_TILED(8, 4);
  }
  if (K <= 2) DVV_TILED(2, 8);
  if (K <= 4) DVV_TILED(4, 8);
  DVV_TILED(8, 8);
#undef DVV_TILED
}

// The one dispatch of a sweep: the tiled kernels where `tiled` (the caller
// has checked K, R and alignment: dvv_ops.py's tiled_path), else the
// general ones; ceil == nullptr sweeps for the mask alone.
int sweep_launch(const void* vvs, const void* ids, const void* ns,
                 const void* valid, void* mask, void* ceil, int64_t N, int K,
                 int R, bool tiled, cudaStream_t s) {
  if (N < 1 || K < 1 || R < 0) return (int)cudaErrorInvalidValue;
  if (tiled)
    return ceil ? launch_tiled_any<true>(vvs, ids, ns, valid, mask, ceil, N,
                                         K, R, s)
                : launch_tiled_any<false>(vvs, ids, ns, valid, mask, nullptr,
                                          N, K, R, s);
  if (!ceil) {
    dvv_sync_mask_kernel<<<grid_for(N * K), kThreads, 0, s>>>(
        (const int32_t*)vvs, (const int32_t*)ids, (const int32_t*)ns,
        (const uint8_t*)valid, (uint8_t*)mask, N, K, R);
    return (int)cudaGetLastError();
  }
  // the general read sweep: a block owns kpb keys, a thread per (key,
  // slot) or (key, column), their mask bytes in static shared memory
  if (K > kMaxSharedKeys) return (int)cudaErrorInvalidValue;
  const int width = K > R ? K : R;
  int kpb = kThreads / width;
  if (kpb > kMaxSharedKeys / K) kpb = kMaxSharedKeys / K;
  if (kpb < 1) kpb = 1;
  dvv_read_sweep_kernel<<<(unsigned)((N + kpb - 1) / kpb), kThreads,
                          (size_t)kpb * K, s>>>(
      (const int32_t*)vvs, (const int32_t*)ids, (const int32_t*)ns,
      (const uint8_t*)valid, (uint8_t*)mask, (int64_t*)ceil, N, K, R, kpb);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` and
// returns the first CUDA error (0 when all went well).

// Mask (and, where ceil is not null, the ceilings) of N keys of K slots
// over R columns; tiled picks the path (sweep_launch).
extern "C" int dvv_sweep_launch(const void* vvs, const void* ids,
                                const void* ns, const void* valid, void* mask,
                                void* ceil, int64_t N, int K, int R, int tiled,
                                void* stream) {
  return sweep_launch(vvs, ids, ns, valid, mask, ceil, N, K, R, tiled != 0,
                      (cudaStream_t)stream);
}

// One sweep from host memory: copy in_bytes of `host` (pinned) to `dev`,
// run the sweep on the arrays at the given byte offsets of `dev` (ceil_off
// < 0: the mask alone), copy out_bytes at out_off back to host + out_off,
// and wait for the stream.
extern "C" int dvv_sweep_staged(void* host, void* dev, int64_t in_bytes,
                                int64_t out_off, int64_t out_bytes,
                                const int64_t* offsets, int64_t N, int K,
                                int R, int tiled, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned char* d = (unsigned char*)dev;
  cudaError_t err = cudaMemcpyAsync(dev, host, in_bytes,
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int rc = sweep_launch(d + offsets[0], d + offsets[1], d + offsets[2],
                              d + offsets[3], d + offsets[4],
                              offsets[5] < 0 ? nullptr : d + offsets[5], N, K,
                              R, tiled != 0, s);
  if (rc != 0) return rc;
  err = cudaMemcpyAsync((unsigned char*)host + out_off, d + out_off,
                        out_bytes, cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(s);
}

extern "C" int dvv_leq_launch(const void* vx, const void* ix, const void* nx,
                              const void* vy, const void* iy, const void* ny,
                              void* out, int64_t N, int R, void* stream) {
  dvv_leq_kernel<<<grid_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)vx, (const int32_t*)ix, (const int32_t*)nx,
      (const int32_t*)vy, (const int32_t*)iy, (const int32_t*)ny,
      (uint8_t*)out, N, R);
  return (int)cudaGetLastError();
}
