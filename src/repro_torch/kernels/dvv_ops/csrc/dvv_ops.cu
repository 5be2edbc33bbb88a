// Dotted-version-vector dominance kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dvv_ops/dvv_ops.py:
//   dvv_sync_mask_kernel  <- dvv_sync_mask_pallas (_sync_mask_kernel)
//   dvv_read_sweep_kernel <- ops.dvv_read_sweep (dvv_sync_mask_pallas
//                            followed by core.batched.merge_context)
//   dvv_leq_kernel        <- dvv_leq_pallas (_leq_kernel)
//
// Encoding (core/batched.py): a clock is vv int32[R], a dot column
// dot_id (-1 = NO_DOT) and the dot's counter dot_n.  x <= y (history(x) is a
// subset of history(y)) holds iff every column is covered,
//     vx[r] <= vy[r]  or  (iy == r and vx[r] == ny == vy[r] + 1),
// and x's dot is covered,  nx <= vy[ix]  or  (iy == ix and nx == ny).
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
//   So the two bounds are of one size; neither is approached by this first
//   design, which is simple and right: one thread per (key, slot x) walks
//   y over K and r over R straight from global memory.  A key's K*R clock
//   block is small and contiguous, so its rows are re-read out of L1, and
//   the walk leaves the column loop at the first uncovered column.  The
//   dot lookup vy[ix] is a direct indexed load, taken only when x has a
//   dot (the TPU's masked lane-sum gave 0 at NO_DOT for free; a direct load
//   at -1 would read out of bounds) and clamped to [0, R) exactly as the
//   plain torch version clamps it.  K and R are runtime loop bounds with
//   no static cap.
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

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).

extern "C" int dvv_sync_mask_launch(const void* vvs, const void* ids,
                                    const void* ns, const void* valid,
                                    void* out, int64_t N, int K, int R,
                                    void* stream) {
  dvv_sync_mask_kernel<<<grid_for(N * K), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)vvs, (const int32_t*)ids, (const int32_t*)ns,
      (const uint8_t*)valid, (uint8_t*)out, N, K, R);
  return (int)cudaGetLastError();
}

extern "C" int dvv_read_sweep_launch(const void* vvs, const void* ids,
                                     const void* ns, const void* valid,
                                     void* mask, void* ceil, int64_t N, int K,
                                     int R, int kpb, void* stream) {
  const int64_t blocks = (N + kpb - 1) / kpb;
  dvv_read_sweep_kernel<<<(unsigned)blocks, kThreads, (size_t)kpb * K,
                          (cudaStream_t)stream>>>(
      (const int32_t*)vvs, (const int32_t*)ids, (const int32_t*)ns,
      (const uint8_t*)valid, (uint8_t*)mask, (int64_t*)ceil, N, K, R, kpb);
  return (int)cudaGetLastError();
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
