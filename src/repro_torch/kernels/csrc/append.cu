// Fused edge-pool append for Hopper (sm_90a): pre-append pair-liveness
// probe + slot scatter of (dst, weight, ts).
//
// Replaces the TPU kernel `append_pallas` / `_kernel` in
// src/repro/kernels/append.py (oracle: `append_ref` in
// src/repro/kernels/ref.py).
//
// What bounds it on the H100: bytes. The probe reads each probed owner
// extent once (dst + ts per entry, one weight per hit) and the scatter
// writes 12 bytes per landed op; there is no arithmetic to speak of, and
// the extents are scattered over a 1.6 GB pool, so the reads are
// latency-exposed, partly coalesced DRAM accesses.
//
// Design: the TPU version walks a prefetched list of touched pool tiles in
// sequential grid steps and carries (best_ts, best_w) in VMEM scratch
// across them. Blocks on Hopper run in no order, so nothing is carried:
//   1. `append_probe`: one warp per probe q with pstart >= 0 and pv >= 0
//      walks its extent, which is contiguous (flat index pstart*BS + e for
//      e < psize) — 32 lanes read 32 neighbouring entries per step, so the
//      walk is coalesced. Each lane keeps its newest matching entry; a
//      warp shuffle reduction takes the maximum ts, and on equal ts the
//      lowest position (the `argmax` of `append_ref`).
//   2. `append_scatter`: one thread per op lands its slot in place.
// Appends land at or after the owner's pre-batch size, so probe and
// scatter touch disjoint entries; launching them in this order on one
// stream is the simple, safe order.
#include <cuda_runtime.h>

__global__ void append_probe(const int* __restrict__ dst,
                             const float* __restrict__ w,
                             const int* __restrict__ ts, long long n_entries,
                             int bs, const int* __restrict__ pstart,
                             const int* __restrict__ psize,
                             const int* __restrict__ pv, int n_probe,
                             bool* __restrict__ was_live) {
  const int q = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= n_probe) return;  // whole warp leaves together
  const int sb = pstart[q];
  const int sz = psize[q];
  const int v = pv[q];
  int best_t = 0;
  long long best_i = -1;
  if (sb >= 0 && v >= 0) {
    const long long base = (long long)sb * bs;
    for (int e = lane; e < sz; e += 32) {
      const long long i = base + e;
      if (i >= n_entries) break;
      if (dst[i] == v) {
        const int t = ts[i];
        if (t > best_t) {  // strict: keeps this lane's lowest position
          best_t = t;
          best_i = i;
        }
      }
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

__global__ void append_scatter(int* __restrict__ dst, float* __restrict__ w,
                               int* __restrict__ ts, int nb, int bs,
                               const int* __restrict__ wblk,
                               const int* __restrict__ wlane,
                               const bool* __restrict__ wval,
                               const int* __restrict__ wd,
                               const float* __restrict__ ww,
                               const int* __restrict__ wts, int n_ops) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_ops || !wval[j]) return;
  const int b = wblk[j];
  const int l = wlane[j];
  if (b < 0 || b >= nb || l < 0 || l >= bs) return;  // JAX drop mode
  const long long i = (long long)b * bs + l;
  dst[i] = wd[j];
  w[i] = ww[j];
  ts[i] = wts[j];
}

extern "C" int append_launch(int* dst, float* w, int* ts, int nb, int bs,
                             const int* wblk, const int* wlane,
                             const bool* wval, const int* wd, const float* ww,
                             const int* wts, int n_ops, const int* pstart,
                             const int* psize, const int* pv, int n_probe,
                             bool* was_live, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_probe > 0) {
    const int threads = 256;  // 8 probes per block
    const long long blocks = ((long long)n_probe * 32 + threads - 1) / threads;
    append_probe<<<(unsigned)blocks, threads, 0, s>>>(
        dst, w, ts, (long long)nb * bs, bs, pstart, psize, pv, n_probe,
        was_live);
  }
  if (n_ops > 0) {
    append_scatter<<<(n_ops + 255) / 256, 256, 0, s>>>(
        dst, w, ts, nb, bs, wblk, wlane, wval, wd, ww, wts, n_ops);
  }
  return (int)cudaGetLastError();
}
