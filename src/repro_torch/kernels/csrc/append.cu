// Fused edge-pool append for Hopper (sm_90a): pre-append pair-liveness
// probe + slot scatter of (dst, weight, ts), in one launch.
//
// Replaces the TPU kernel `append_pallas` / `_kernel` in
// src/repro/kernels/append.py (oracle: `append_ref` in
// src/repro/kernels/ref.py).
//
// What bounds it on the H100: bytes. The probe reads each probed owner
// extent once (dst per entry, ts and weight only on a match) and the
// scatter writes 12 bytes per landed op; there is no arithmetic to speak
// of, and the extents are scattered over a 1.6 GB pool, so the reads are
// latency-exposed DRAM accesses. At a few microseconds of work a call, the
// launch is most of the time: hence one launch, not two.
//
// Design: the TPU version walks a prefetched list of touched pool tiles in
// sequential grid steps and carries (best_ts, best_w) in VMEM scratch
// across them. Blocks on Hopper run in no order, so nothing is carried.
// One grid, two kinds of block:
//   * blocks [0, probe_blocks): one warp per probe q with pstart >= 0 and
//     pv >= 0 walks its extent, which is contiguous (flat index
//     pstart*BS + e for e < psize). With BS a multiple of 4 (64 bytes a
//     block row at BS = 16) each lane reads 4 destinations in one 16-byte
//     load, 128 entries a warp step; ts is read only on a match. Each lane
//     keeps its newest match (lowest position on equal ts); a warp shuffle
//     reduction takes the maximum ts, and on equal ts the lowest position
//     (the `argmax` of `append_ref`); the weight is read once, for the
//     winner.
//   * the remaining blocks: one thread per op lands its slot in place,
//     dropping ops with wval false; (wblk, wlane) follow JAX's
//     `.at[].set(mode="drop")`: a negative index counts from the end, one
//     outside [-n, n) drops the op.
// Why one launch is safe: the caller claims every append slot at or after
// its owner's pre-batch size (src/repro/kernels/append.py:17-19), so no
// slot a scatter thread writes lies in any probed range [pstart*BS,
// pstart*BS + psize). Probes and writes touch disjoint entries and may run
// in any order. A 16-byte probe load may cover slots past psize that are
// being written; those lanes of the load are discarded.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 256;  // 8 probes, or 256 ops, a block

// Keep entry i when its ts is newer (strictly: this lane's lowest position
// wins among equal ts, since a lane walks its positions upwards).
__device__ __forceinline__ void take(int t, long long i, int& best_t,
                                     long long& best_i) {
  if (t > best_t) {
    best_t = t;
    best_i = i;
  }
}

__global__ void append_kernel(int* __restrict__ dst, float* __restrict__ w,
                              int* __restrict__ ts, int nb, int bs,
                              const int* __restrict__ wblk,
                              const int* __restrict__ wlane,
                              const bool* __restrict__ wval,
                              const int* __restrict__ wd,
                              const float* __restrict__ ww,
                              const int* __restrict__ wts, int n_ops,
                              const int* __restrict__ pstart,
                              const int* __restrict__ psize,
                              const int* __restrict__ pv, int n_probe,
                              bool* __restrict__ was_live, int probe_blocks) {
  if ((int)blockIdx.x >= probe_blocks) {  // scatter
    const int j = (blockIdx.x - probe_blocks) * blockDim.x + threadIdx.x;
    if (j >= n_ops || !wval[j]) return;
    const int b = wblk[j];
    const int l = wlane[j];
    // JAX's drop mode: a negative index counts from the end, one outside
    // [-n, n) drops the op
    if (b < -nb || b >= nb || l < -bs || l >= bs) return;
    const long long i =
        (long long)(b < 0 ? b + nb : b) * bs + (l < 0 ? l + bs : l);
    dst[i] = wd[j];
    w[i] = ww[j];
    ts[i] = wts[j];
    return;
  }
  const int q = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= n_probe) return;  // whole warp leaves together
  const int sb = pstart[q];
  const int sz = psize[q];
  const int v = pv[q];
  int best_t = 0;
  long long best_i = -1;
  if (sb >= 0 && v >= 0 && sz > 0) {
    const long long n = (long long)nb * bs;
    const long long base = (long long)sb * bs;
    const long long end = base + sz < n ? base + sz : n;
    if ((bs & 3) == 0 && ((uintptr_t)dst & 15) == 0) {
      // base and n are multiples of 4: a load at i < end stays in the pool
      for (long long i = base + 4 * lane; i < end; i += 128) {
        const int4 d = *reinterpret_cast<const int4*>(dst + i);
        if (d.x == v) take(ts[i], i, best_t, best_i);
        if (d.y == v && i + 1 < end) take(ts[i + 1], i + 1, best_t, best_i);
        if (d.z == v && i + 2 < end) take(ts[i + 2], i + 2, best_t, best_i);
        if (d.w == v && i + 3 < end) take(ts[i + 3], i + 3, best_t, best_i);
      }
    } else {
      for (long long i = base + lane; i < end; i += 32)
        if (dst[i] == v) take(ts[i], i, best_t, best_i);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int ot = __shfl_down_sync(0xffffffffu, best_t, off);
    const long long oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (ot > best_t || (ot == best_t && ot > 0 && oi < best_i)) {
      best_t = ot;
      best_i = oi;
    }
  }
  if (lane == 0) was_live[q] = best_t > 0 && w[best_i] != 0.0f;
}

extern "C" int append_launch(int* dst, float* w, int* ts, int nb, int bs,
                             const int* wblk, const int* wlane,
                             const bool* wval, const int* wd, const float* ww,
                             const int* wts, int n_ops, const int* pstart,
                             const int* psize, const int* pv, int n_probe,
                             bool* was_live, void* stream) {
  const long long probe_blocks = ((long long)n_probe + THREADS / 32 - 1) /
                                 (THREADS / 32);
  const long long op_blocks = ((long long)n_ops + THREADS - 1) / THREADS;
  if (probe_blocks + op_blocks == 0) return 0;
  append_kernel<<<(unsigned)(probe_blocks + op_blocks), THREADS, 0,
                  (cudaStream_t)stream>>>(
      dst, w, ts, nb, bs, wblk, wlane, wval, wd, ww, wts, n_ops, pstart,
      psize, pv, n_probe, was_live, (int)probe_blocks);
  return (int)cudaGetLastError();
}
