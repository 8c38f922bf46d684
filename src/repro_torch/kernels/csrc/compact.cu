// Row compactors for Hopper (sm_90a): log compaction (paper Alg. 2) and the
// streaming defrag's per-vertex pass, one kernel templated on the emission
// order and the weight type.
//
// Replaces the TPU kernels `compact_rows_pallas` / `_kernel` and
// `defrag_rows_pallas` / `_defrag_kernel` in src/repro/kernels/compact.py
// (oracles: `compact_rows_ref`, `defrag_rows_ref` in
// src/repro/kernels/ref.py). Unlike the TPU version, `keep_all` (the
// 'grow' policy) is handled here too: it is the same kernel with another
// keep mask.
//
// What bounds it on the H100: bytes — each row's occupied entries are read
// once and every output entry is written once; the in-block sort is a few
// thousand shared-memory compare-exchanges per row.
//
// Design: the TPU kernels keep a duplicate-checker bitmap over the whole
// destination universe in VMEM (n_cap bits; four such arrays for defrag).
// At n_cap = 2^23 that is 1 MiB per array, far over a block's 227 KB of
// shared memory, so the work is row-local instead: one block per row loads
// the row's valid entries (pos < size, dst >= 0, ts <= read_ts when given)
// as 64-bit (dst << 32 | pos) keys, bitonic-sorts them in shared memory
// (32 KB at D = 4096), marks the last entry of each dst run (the highest
// position wins), keeps it when its weight is non-zero (every valid entry
// under keep_all), and ranks the survivors with a block-wide scan:
//   MODE 0 (compact_rows): keep flags are scattered back to positions and
//     scanned in descending position order (reverse-scan emission);
//   MODE 1 (defrag_rows): flags are scanned in sorted (dst-ascending)
//     order.
// Survivors are copied from global memory to their rank; the rest of the
// row is filled with (-1, 0, 0).
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename WT>
__device__ __forceinline__ WT zero_w();
template <>
__device__ __forceinline__ float zero_w<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_w<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Exclusive block scan of one int per thread (blockDim.x a multiple of 32).
__device__ int block_exclusive_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) wsum[lane] = s;
  }
  __syncthreads();
  *total = wsum[nw - 1];
  const int before = wid > 0 ? wsum[wid - 1] : 0;
  __syncthreads();
  return before + x - v;
}

template <typename WT, int MODE>
__global__ void rows_kernel(const int* __restrict__ dst,
                            const WT* __restrict__ w,
                            const int* __restrict__ ts,
                            const int* __restrict__ size, int D, int npad,
                            int use_read_ts, int read_ts, int keep_all,
                            int* __restrict__ odst, WT* __restrict__ ow,
                            int* __restrict__ ots, int* __restrict__ ocnt,
                            int* __restrict__ olive) {
  extern __shared__ unsigned long long smem_raw[];
  long long* key = reinterpret_cast<long long*>(smem_raw);  // npad
  int* flag = reinterpret_cast<int*>(key + npad);            // npad
  __shared__ int wsum[32];
  __shared__ int s_live;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int* rd = dst + row * D;
  const WT* rw = w + row * D;
  const int* rt = ts + row * D;
  int lim = size[row];
  lim = lim < 0 ? 0 : (lim > D ? D : lim);

  if (tid == 0) s_live = 0;
  for (int i = tid; i < npad; i += nt) {
    long long k = LLONG_MAX;
    if (i < lim) {
      const int d = rd[i];
      bool ok = d >= 0;
      if (use_read_ts) ok = ok && rt[i] <= read_ts;
      if (ok) k = ((long long)d << 32) | (long long)i;
    }
    key[i] = k;
    flag[i] = 0;
  }
  __syncthreads();

  // bitonic sort, ascending: (dst, pos) order
  for (int k2 = 2; k2 <= npad; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < npad; i += nt) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const long long a = key[i];
          const long long b = key[ixj];
          const bool up = (i & k2) == 0;
          if ((a > b) == up) {
            key[i] = b;
            key[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // last entry of each dst run wins; keep it unless it is a tombstone
  int live = 0;
  for (int i = tid; i < npad; i += nt) {
    const long long k = key[i];
    if (k == LLONG_MAX) continue;
    const bool last = (i + 1 == npad) || ((key[i + 1] >> 32) != (k >> 32));
    const int pos = (int)(k & 0xffffffffLL);
    const bool alive = last && to_f(rw[pos]) != 0.0f;
    live += alive;
    if (MODE == 0) {
      if (alive) flag[npad - 1 - pos] = 1;  // descending position order
    } else {
      flag[i] = keep_all ? 1 : (int)alive;  // sorted order
    }
  }
  if (MODE == 1 && live) atomicAdd(&s_live, live);
  __syncthreads();

  // exclusive scan of flag; each thread owns a contiguous chunk
  const int per = npad / nt;
  const int lo = tid * per;
  int local = 0;
  for (int i = 0; i < per; ++i) local += flag[lo + i];
  int total = 0;
  int run = block_exclusive_scan(local, wsum, &total);
  for (int i = 0; i < per; ++i) {
    const int f = flag[lo + i];
    flag[lo + i] = (run << 1) | f;  // rank and keep bit
    run += f;
  }
  __syncthreads();

  int* od = odst + row * D;
  WT* owr = ow + row * D;
  int* ot = ots + row * D;
  for (int i = tid; i < npad; i += nt) {
    const int f = flag[i];
    if (!(f & 1)) continue;
    const int rank = f >> 1;
    const int pos = MODE == 0 ? npad - 1 - i : (int)(key[i] & 0xffffffffLL);
    od[rank] = rd[pos];
    owr[rank] = rw[pos];
    ot[rank] = rt[pos];
  }
  for (int e = total + tid; e < D; e += nt) {
    od[e] = -1;
    owr[e] = zero_w<WT>();
    ot[e] = 0;
  }
  if (tid == 0) {
    ocnt[row] = total;
    if (MODE == 1) olive[row] = s_live;
  }
}

template <typename WT, int MODE>
static int launch_rows(const int* dst, const WT* w, const int* ts,
                       const int* size, int K, int D, int use_read_ts,
                       int read_ts, int keep_all, int* odst, WT* ow, int* ots,
                       int* ocnt, int* olive, void* stream) {
  int npad = 32;
  while (npad < D) npad <<= 1;
  const int threads = npad < 512 ? npad : 512;
  const size_t smem = (size_t)npad * (sizeof(long long) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel<WT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rows_kernel<WT, MODE><<<K, threads, smem, (cudaStream_t)stream>>>(
      dst, w, ts, size, D, npad, use_read_ts, read_ts, keep_all, odst, ow,
      ots, ocnt, olive);
  return (int)cudaGetLastError();
}

// wdtype: 0 = float32, 1 = bfloat16. mode: 0 = compact_rows, 1 = defrag_rows.
extern "C" int rows_launch(int mode, int wdtype, const int* dst, const void* w,
                           const int* ts, const int* size, int K, int D,
                           int use_read_ts, int read_ts, int keep_all,
                           int* odst, void* ow, int* ots, int* ocnt,
                           int* olive, void* stream) {
  if (K <= 0 || D <= 0) return 0;
  if (wdtype == 0) {
    const float* wf = (const float*)w;
    float* owf = (float*)ow;
    return mode == 0
               ? launch_rows<float, 0>(dst, wf, ts, size, K, D, use_read_ts,
                                       read_ts, keep_all, odst, owf, ots, ocnt,
                                       olive, stream)
               : launch_rows<float, 1>(dst, wf, ts, size, K, D, use_read_ts,
                                       read_ts, keep_all, odst, owf, ots, ocnt,
                                       olive, stream);
  }
  const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
  __nv_bfloat16* owb = (__nv_bfloat16*)ow;
  return mode == 0
             ? launch_rows<__nv_bfloat16, 0>(dst, wb, ts, size, K, D,
                                             use_read_ts, read_ts, keep_all,
                                             odst, owb, ots, ocnt, olive,
                                             stream)
             : launch_rows<__nv_bfloat16, 1>(dst, wb, ts, size, K, D,
                                             use_read_ts, read_ts, keep_all,
                                             odst, owb, ots, ocnt, olive,
                                             stream);
}
