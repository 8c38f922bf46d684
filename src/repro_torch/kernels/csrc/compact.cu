// Row compactors for Hopper (sm_90a): log compaction (paper Alg. 2) and the
// streaming defrag's per-vertex pass.
//
// Replaces the TPU kernels `compact_rows_pallas` / `_kernel` and
// `defrag_rows_pallas` / `_defrag_kernel` in src/repro/kernels/compact.py
// (oracles: `compact_rows_ref`, `defrag_rows_ref` in
// src/repro/kernels/ref.py). Unlike the TPU version, `keep_all` (the
// 'grow' policy) is handled here too: it is the same kernel with another
// keep mask.
//
// What bounds it on the H100: bytes — each row's occupied entries are read
// once and every output entry is written once. Most rows hold a handful of
// entries, so the work besides the output fill has to follow the row's
// occupancy `lim = clamp(size, 0, D)`, not its width D.
//
// The TPU kernels keep a duplicate-checker bitmap over the whole
// destination universe in VMEM (n_cap bits; four such arrays for defrag).
// At n_cap = 2^23 that is 1 MiB per array, far over a block's 227 KB of
// shared memory, so the work is row-local instead. Valid entries are
// pos < lim, 0 <= dst < 2^30 and, when given, ts <= read_ts.
//
// compact_rows (MODE 0), rows up to HASH_MAX_D wide: `compact_hash_kernel`.
//   Nothing is sorted. Each row builds an open-addressing table keyed by dst
//   in shared memory (next_pow2(2 lim) slots, at least 64, of 8 bytes:
//   dst << 32 | pos); `atomicMax` on a slot keeps the highest position, the
//   last writer; entries go in by descending position, so a repeated dst
//   mostly finds its slot higher already and skips the atomicMax. A second
//   pass walks positions lim-1 .. 0 and keeps entry p when the table's
//   position for dst[p] is p and its weight is non-zero;
//   a ballot and `__popc` rank the kept entries in that (descending
//   position) order, and they are copied to their rank. Only the fill of
//   the rest of the row with (-1, 0, 0) touches all D entries.
//   A block takes several rows, one per warp. A row with lim <= WARP_ROW is
//   done by its warp alone (a table of at most 512 slots, 4 KB, per warp;
//   ballots only, no __syncthreads): every row of the in-window tier
//   (D = probe_width = 256) and most read rows. A longer row is queued and
//   done by the whole block once its warps have finished their short rows
//   (table of up to 16,384 slots, 128 KB at D = 8192; a block scan of the
//   ballot counts per step of blockDim positions). Few rows a launch (the
//   big-vertex tier: 16 rows of 4096) get one row a block, so each row has
//   an SM of its own.
//
// defrag_rows (MODE 1), and compact_rows rows wider than HASH_MAX_D (up to
// MAX_ROW_WIDTH = 16384, where the table would pass 227 KB): `rows_kernel`,
// one block per row. It loads the row's valid entries as 64-bit
// (dst << 32 | pos) keys, bitonic-sorts all next_pow2(D) keys in shared
// memory, marks the last entry of each dst run (the highest position
// wins), keeps it when its weight is non-zero (every valid entry under
// keep_all), and ranks the survivors with a block-wide scan:
//   MODE 0: keep flags are scattered back to positions and scanned in
//     descending position order (reverse-scan emission);
//   MODE 1: flags are scanned in sorted (dst-ascending) order.
//
// The dynamic shared-memory limit of each kernel instance is raised once
// per device, to the most that instance can ask for.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int BIGD = 1 << 30;         // valid destinations lie below
constexpr int WARP_ROW = 256;         // rows up to this occupancy: one warp
constexpr int HASH_MAX_D = 8192;      // compact_rows rows up to this width
constexpr int HASH_MIN_BITS = 6;      // at least 64 slots a table
constexpr int HASH_WARPS_WIDE = 16;   // warps a block when D > WARP_ROW
constexpr int HASH_WARPS_NARROW = 4;  // warps a block when D <= WARP_ROW
constexpr int BLOCKS_PER_SM = 2;      // wide rows: blocks a launch, per SM
constexpr int HASH_MAX_SMEM = (2 * HASH_MAX_D) * 8;
constexpr int SORT_MAX_SMEM = 16384 * 12;
constexpr unsigned long long EMPTY = ~0ull;  // dst field 0xffffffff: none
constexpr unsigned FULL = 0xffffffffu;

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
// four weights in one store: 16 bytes of float, 8 of bfloat16
template <typename WT>
struct Vec4;
template <>
struct Vec4<float> {
  typedef float4 T;
};
template <>
struct Vec4<__nv_bfloat16> {
  typedef uint2 T;
};

__device__ __forceinline__ bool entry_ok(int d, const int* rt, int p,
                                         int use_read_ts, int read_ts) {
  return d >= 0 && d < BIGD && (!use_read_ts || rt[p] <= read_ts);
}

// Fill entries [from, D) of an output row with (-1, 0, 0): 16-byte stores
// from the first multiple of 4 on when D is one (rows start aligned).
template <typename WT>
__device__ __forceinline__ void fill_empty(int* od, WT* ow, int* ot,
                                           int from, int D, int t, int nt) {
  const int head = (D & 3) ? D : ((from + 3) & ~3);
  for (int e = from + t; e < head; e += nt) {
    od[e] = -1;
    ow[e] = zero_w<WT>();
    ot[e] = 0;
  }
  typedef typename Vec4<WT>::T V;
  const V z{};  // all bits zero: +0.0
  for (int e = head + 4 * t; e < D; e += 4 * nt) {
    *reinterpret_cast<int4*>(od + e) = make_int4(-1, -1, -1, -1);
    *reinterpret_cast<V*>(ow + e) = z;
    *reinterpret_cast<int4*>(ot + e) = make_int4(0, 0, 0, 0);
  }
}

// ---- compact_rows: shared-memory hash table per row --------------------

__host__ __device__ __forceinline__ int table_bits(int lim) {
  int b = HASH_MIN_BITS;
  while ((1 << b) < 2 * lim) ++b;
  return b;
}

__device__ __forceinline__ unsigned slot_of(int d, int bits) {
  return ((unsigned)d * 0x9E3779B1u) >> (32 - bits);  // Fibonacci hashing
}

// Claim dst d's slot (or find it) and raise its position to p.
__device__ __forceinline__ void tab_insert(unsigned long long* tab, int bits,
                                           int d, int p) {
  const unsigned mask = (1u << bits) - 1;
  const unsigned long long v =
      ((unsigned long long)(unsigned)d << 32) | (unsigned)p;
  for (unsigned h = slot_of(d, bits);; h = (h + 1) & mask) {
    const unsigned long long cur = atomicCAS(&tab[h], EMPTY, v);
    if (cur == EMPTY) return;
    if ((unsigned)(cur >> 32) == (unsigned)d) {
      // same dst in the high half: raise the position, unless it is
      // already higher (rows are inserted by descending position, so
      // mostly it is)
      if (cur < v) atomicMax(&tab[h], v);
      return;
    }
  }
}

// The highest position of dst d (d was inserted).
__device__ __forceinline__ int tab_find(const unsigned long long* tab,
                                        int bits, int d) {
  const unsigned mask = (1u << bits) - 1;
  for (unsigned h = slot_of(d, bits);; h = (h + 1) & mask) {
    const unsigned long long cur = tab[h];
    if ((unsigned)(cur >> 32) == (unsigned)d) return (int)(unsigned)cur;
  }
}

// Whether entry p survives: valid, the last writer of its dst, not a
// tombstone.
template <typename WT>
__device__ __forceinline__ bool survives(const WT* rw, const int* rt, int p,
                                         int d, int use_read_ts, int read_ts,
                                         const unsigned long long* tab,
                                         int bits) {
  return entry_ok(d, rt, p, use_read_ts, read_ts) &&
         tab_find(tab, bits, d) == p && to_f(rw[p]) != 0.0f;
}

// One row of lim <= WARP_ROW entries, by one warp.
template <typename WT>
__device__ void compact_row_warp(const int* rd, const WT* rw, const int* rt,
                                 int lim, int D, int use_read_ts, int read_ts,
                                 unsigned long long* tab, int* od, WT* owr,
                                 int* ot, int* cnt) {
  const int lane = threadIdx.x & 31;
  const int bits = table_bits(lim);
  for (int s = lane; s < (1 << bits); s += 32) tab[s] = EMPTY;
  __syncwarp();
  for (int p = lim - 1 - lane; p >= 0; p -= 32) {  // descending position
    const int d = rd[p];
    if (entry_ok(d, rt, p, use_read_ts, read_ts)) tab_insert(tab, bits, d, p);
  }
  __syncwarp();
  int run = 0;
  for (int base = 0; base < lim; base += 32) {
    const int p = lim - 1 - base - lane;  // descending position
    int d = -1;
    bool keep = false;
    WT wq = zero_w<WT>();
    int tq = 0;
    if (p >= 0) {
      d = rd[p];
      if (entry_ok(d, rt, p, use_read_ts, read_ts) &&
          tab_find(tab, bits, d) == p) {  // the last writer: load w and ts
        wq = rw[p];                        // together, one latency a step
        tq = rt[p];
        keep = to_f(wq) != 0.0f;
      }
    }
    const unsigned bal = __ballot_sync(FULL, keep);
    if (keep) {
      const int r = run + __popc(bal & ((1u << lane) - 1));
      od[r] = d;
      owr[r] = wq;
      ot[r] = tq;
    }
    run += __popc(bal);
  }
  fill_empty(od, owr, ot, run, D, lane, 32);
  if (lane == 0) *cnt = run;
  __syncwarp();  // the table is reused by the warp's next row
}

// One row of lim > WARP_ROW entries, by the whole block.
template <typename WT>
__device__ void compact_row_block(const int* rd, const WT* rw, const int* rt,
                                  int lim, int D, int use_read_ts,
                                  int read_ts, unsigned long long* tab,
                                  int* wsum, int* od, WT* owr, int* ot,
                                  int* cnt) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nw = nt >> 5;
  const int bits = table_bits(lim);
  for (int s = tid; s < (1 << bits); s += nt) tab[s] = EMPTY;
  __syncthreads();
  for (int p = lim - 1 - tid; p >= 0; p -= nt) {  // descending position
    const int d = rd[p];
    if (entry_ok(d, rt, p, use_read_ts, read_ts)) tab_insert(tab, bits, d, p);
  }
  __syncthreads();
  int run = 0;
  for (int base = 0; base < lim; base += nt) {
    const int p = lim - 1 - base - tid;
    int d = -1;
    bool keep = false;
    if (p >= 0) {
      d = rd[p];
      keep = survives(rw, rt, p, d, use_read_ts, read_ts, tab, bits);
    }
    const unsigned bal = __ballot_sync(FULL, keep);
    if (lane == 0) wsum[wid] = __popc(bal);
    __syncthreads();
    // every warp scans the per-warp counts itself
    int s = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    const int incl = __shfl_sync(FULL, s, wid > 0 ? wid - 1 : 0);
    const int total = __shfl_sync(FULL, s, nw - 1);
    if (keep) {
      const int r = run + (wid > 0 ? incl : 0) +
                    __popc(bal & ((1u << lane) - 1));
      od[r] = d;
      owr[r] = rw[p];
      ot[r] = rt[p];
    }
    run += total;
    __syncthreads();  // wsum is rewritten by the next step
  }
  fill_empty(od, owr, ot, run, D, tid, nt);
  if (tid == 0) *cnt = run;
}

// rows_per_block rows a block, row b * rows_per_block + w for warp w;
// warp tables of 1 << warp_bits slots each, then the block's long rows.
template <typename WT>
__global__ void compact_hash_kernel(const int* __restrict__ dst,
                                    const WT* __restrict__ w,
                                    const int* __restrict__ ts,
                                    const int* __restrict__ size, long long K,
                                    int D, int use_read_ts, int read_ts,
                                    int rows_per_block, int warp_bits,
                                    int* __restrict__ odst,
                                    WT* __restrict__ ow,
                                    int* __restrict__ ots,
                                    int* __restrict__ ocnt) {
  extern __shared__ unsigned long long tab[];
  __shared__ int wsum[32];
  __shared__ int big[32];
  __shared__ int nbig;
  const int wid = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  if (threadIdx.x == 0) nbig = 0;
  __syncthreads();
  if (wid < rows_per_block && row0 + wid < K) {
    const long long row = row0 + wid;
    int lim = size[row];
    lim = lim < 0 ? 0 : (lim > D ? D : lim);
    if (lim <= WARP_ROW) {
      compact_row_warp(dst + row * D, w + row * D, ts + row * D, lim, D,
                       use_read_ts, read_ts,
                       tab + ((long long)wid << warp_bits), odst + row * D,
                       ow + row * D, ots + row * D, ocnt + row);
    } else if ((threadIdx.x & 31) == 0) {
      big[atomicAdd(&nbig, 1)] = wid;
    }
  }
  __syncthreads();
  const int n_big = nbig;
  for (int i = 0; i < n_big; ++i) {
    const long long row = row0 + big[i];
    int lim = size[row];
    lim = lim > D ? D : lim;
    compact_row_block(dst + row * D, w + row * D, ts + row * D, lim, D,
                      use_read_ts, read_ts, tab, wsum, odst + row * D,
                      ow + row * D, ots + row * D, ocnt + row);
  }
}

// ---- defrag_rows, and compact_rows rows wider than HASH_MAX_D: sort ------

// Exclusive block scan of one int per thread (blockDim.x a multiple of 32).
__device__ int block_exclusive_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
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
    if (i < lim && entry_ok(rd[i], rt, i, use_read_ts, read_ts))
      k = ((long long)rd[i] << 32) | (long long)i;
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
  fill_empty(od, owr, ot, total, D, tid, nt);
  if (tid == 0) {
    ocnt[row] = total;
    if (MODE == 1) olive[row] = s_live;
  }
}

// ---- launch ---------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit on the current device, once
// per device (a bit each in *done).
template <typename Kernel>
static int ensure_smem(Kernel* kernel, int bytes, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (*done & bit) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done |= bit;
  return (int)err;
}

// The current device's SM count, read once per device.
static int sm_count(int* sms) {
  static int cache[32] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && cache[dev]) {
    *sms = cache[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 32) cache[dev] = *sms;
  return (int)err;
}

template <typename WT>
static int launch_hash(const int* dst, const WT* w, const int* ts,
                       const int* size, int K, int D, int use_read_ts,
                       int read_ts, int* odst, WT* ow, int* ots, int* ocnt,
                       void* stream) {
  static unsigned done = 0;
  const bool wide = D > WARP_ROW;
  const int nw = wide ? HASH_WARPS_WIDE : HASH_WARPS_NARROW;
  const int warp_bits = table_bits(wide ? WARP_ROW : D);
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  // wide rows: as few rows a block as keep BLOCKS_PER_SM blocks on every
  // SM, so a launch of few rows (the big tier) gives each row an SM of its
  // own; narrow rows: a warp each
  const long long per = (long long)BLOCKS_PER_SM * sms;
  long long rpb = wide ? (K + per - 1) / per : nw;
  rpb = rpb < 1 ? 1 : (rpb > nw ? nw : rpb);
  size_t slots = (size_t)rpb << warp_bits;
  if (wide && ((size_t)1 << table_bits(D)) > slots)
    slots = (size_t)1 << table_bits(D);
  err = ensure_smem(compact_hash_kernel<WT>, HASH_MAX_SMEM, &done);
  if (err) return err;
  const unsigned blocks = (unsigned)((K + rpb - 1) / rpb);
  compact_hash_kernel<WT><<<blocks, nw * 32, slots * 8,
                            (cudaStream_t)stream>>>(
      dst, w, ts, size, K, D, use_read_ts, read_ts, (int)rpb, warp_bits,
      odst, ow, ots, ocnt);
  return (int)cudaGetLastError();
}

template <typename WT, int MODE>
static int launch_sort(const int* dst, const WT* w, const int* ts,
                       const int* size, int K, int D, int use_read_ts,
                       int read_ts, int keep_all, int* odst, WT* ow, int* ots,
                       int* ocnt, int* olive, void* stream) {
  static unsigned done = 0;
  int npad = 32;
  while (npad < D) npad <<= 1;
  const int threads = npad < 512 ? npad : 512;
  const size_t smem = (size_t)npad * (sizeof(long long) + sizeof(int));
  const int err = ensure_smem(rows_kernel<WT, MODE>, SORT_MAX_SMEM, &done);
  if (err) return err;
  rows_kernel<WT, MODE><<<K, threads, smem, (cudaStream_t)stream>>>(
      dst, w, ts, size, D, npad, use_read_ts, read_ts, keep_all, odst, ow,
      ots, ocnt, olive);
  return (int)cudaGetLastError();
}

template <typename WT>
static int launch_rows(int mode, const int* dst, const WT* w, const int* ts,
                       const int* size, int K, int D, int use_read_ts,
                       int read_ts, int keep_all, int* odst, WT* ow, int* ots,
                       int* ocnt, int* olive, void* stream) {
  if (mode == 0 && D <= HASH_MAX_D)
    return launch_hash<WT>(dst, w, ts, size, K, D, use_read_ts, read_ts, odst,
                           ow, ots, ocnt, stream);
  if (mode == 0)
    return launch_sort<WT, 0>(dst, w, ts, size, K, D, use_read_ts, read_ts,
                              keep_all, odst, ow, ots, ocnt, olive, stream);
  return launch_sort<WT, 1>(dst, w, ts, size, K, D, use_read_ts, read_ts,
                            keep_all, odst, ow, ots, ocnt, olive, stream);
}

// wdtype: 0 = float32, 1 = bfloat16. mode: 0 = compact_rows, 1 =
// defrag_rows (olive may be null for mode 0). D <= 16384.
extern "C" int rows_launch(int mode, int wdtype, const int* dst, const void* w,
                           const int* ts, const int* size, int K, int D,
                           int use_read_ts, int read_ts, int keep_all,
                           int* odst, void* ow, int* ots, int* ocnt,
                           int* olive, void* stream) {
  if (K <= 0 || D <= 0) return 0;
  if (wdtype == 0)
    return launch_rows<float>(mode, dst, (const float*)w, ts, size, K, D,
                              use_read_ts, read_ts, keep_all, odst,
                              (float*)ow, ots, ocnt, olive, stream);
  return launch_rows<__nv_bfloat16>(
      mode, dst, (const __nv_bfloat16*)w, ts, size, K, D, use_read_ts,
      read_ts, keep_all, odst, (__nv_bfloat16*)ow, ots, ocnt, olive, stream);
}
