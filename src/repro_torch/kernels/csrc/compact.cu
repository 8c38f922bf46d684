// Row compactors for Hopper (sm_90a): log compaction (paper Alg. 2) and the
// streaming defrag's per-vertex pass.
//
// Replaces the TPU kernels `compact_rows_pallas` / `_kernel`
// (src/repro/kernels/compact.py:85) and `defrag_rows_pallas` /
// `_defrag_kernel` (src/repro/kernels/compact.py:230); oracles
// `compact_rows_ref`, `defrag_rows_ref` in src/repro/kernels/ref.py.
// Unlike the TPU version, `keep_all` (the 'grow' policy) is handled here
// too: it is the same kernel with another keep mask.
//
// What bounds both on the H100: bytes. Each row's occupied entries are
// read once (dst; w and ts only of last writers and survivors) and every
// output entry is written once. Most rows hold a handful of entries, so
// the work besides the output fill has to follow the row's occupancy
// `lim = clamp(size, 0, D)`, not its width D. Measured (chip_smoke.py on
// an H100), defrag_rows is far from that bound: its sort's compare
// steps and barriers, not bytes, set its time (0.032 ms for 32 rows of up
// to 4,096 entries against a 0.0006 ms byte bound).
//
// The TPU kernels keep a duplicate-checker bitmap over the whole
// destination universe in VMEM (n_cap bits; four such arrays for defrag,
// src/repro/kernels/compact.py:266-269). At n_cap = 2^23 that is 1 MiB per
// array, far over a block's 227 KB of shared memory, so the work is
// row-local instead. Valid entries are pos < lim, 0 <= dst < 2^30 and, for
// compact_rows when given, ts <= read_ts.
//
// compact_rows, rows up to HASH_MAX_D wide: `compact_hash_kernel`.
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
// compact_rows rows wider than HASH_MAX_D (up to MAX_ROW_WIDTH = 16384,
//   where the table would pass 227 KB): `compact_sort_kernel`, one block
//   per row, a bitonic sort of next_pow2(D) (dst << 32 | pos) keys in
//   shared memory, then a scan of the keep flags in descending position.
//
// defrag_rows: survivors in ascending dst order, so it sorts (a table
//   would need a sort after it anyway). The key of entry p is dst << 32 | p
//   (dst field 0x7fffffff for an entry that is not valid, and for padding
//   past lim), so every key of a row is distinct and the last writer of a
//   dst is the last key of its dst run. Any row width; the sort follows
//   `lim`, not D:
//   * lim <= 256: one warp, in registers. E = next_pow2(lim)/32 keys a
//     lane (1 .. 8), a bitonic network of shuffles (strides < 32) and
//     register swaps (strides >= 32) run only to stage next_pow2(lim) (a
//     row of one entry sorts nothing); runs marked with one shuffle,
//     ranked with ballots, written; no shared memory, no block barrier.
//     Every row of the 16-wide tier, most of the 128-wide one.
//   * 256 < lim <= RUN (4,096): one block, keys in shared memory
//     (next_pow2(lim) x 8 bytes, 32 KB at most). The warps sort chunks
//     of 32 E keys in registers (E = 1 .. 8, as wide as keeps every warp
//     busy); of each later merge stage only the strides >= 32 E go through
//     shared memory, the rest run in registers again. Then one warp pass
//     marks runs and keeps ballots per 32 keys, a warp scans the counts of
//     256-key chunks, and the survivors are written to their rank.
//   `defrag_warp_kernel` takes D <= 256: a warp per row, 8 rows a block,
//   registers sized by D. The 16-wide tier's chunks (up to ~1.4M rows)
//   are most of a rebuild's defrag time, and a kernel sized for rows up
//   to 4,096 holds 74 registers a thread, too many to fill the SMs with
//   their warps (1,048,576 x 16: 1.01 ms there, 0.40 ms here,
//   chip_smoke.py on an H100).
//   `defrag_small_kernel` takes 256 < D <= RUN: a warp per row, rows
//   past 256 done by the whole block afterwards, as in the hash kernel.
//   Dynamic shared memory is sized by next_pow2(D); each row's sort by
//   its own lim.
//   * D > RUN (the wide tier: hubs past dmax; no limit but memory): rows
//     past RUN entries are sorted in runs in device memory and merged, so
//     a row spreads over many SMs (runs of 16,384, one block each, took
//     0.185 ms on the main path's 22 x 45,536 chunk; runs of 4,096, 0.133
//     ms, chip_smoke.py on an H100). `defrag_run_kernel`:
//     one block per (row, run of 4,096 positions) sorts its run as above
//     and writes it to scratch (the wrapper's `torch.empty`, 2 x K x D
//     int64); a row of at most RUN entries is done whole by its first
//     block there, and its other blocks only fill. `defrag_merge_kernel`:
//     ceil(log2(D / RUN)) passes, each merging pairs of runs; a block
//     takes one tile of 4,096 outputs, finds its split with a merge-path
//     binary search, stages both slices in shared memory and places each
//     key by its rank in the other slice (keys are distinct). Then
//     `defrag_count_kernel` counts keeps per tile, `defrag_scan_kernel`
//     scans each row's tile counts (count and live), and
//     `defrag_write_kernel` writes the survivors and fills the row.
//     Splitting by destination range instead would make a partition as
//     wide as the row when one hub rewrites one dst thousands of times;
//     runs by position cannot be skewed. A cluster holding the row in
//     distributed shared memory would cap rows at ~130K entries; this has
//     no cap but memory. A wide launch is 4 + ceil(log2(D / RUN))
//     kernels; the wrapper counts each.
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

// defrag_rows
constexpr int CHUNK = 256;            // keys a warp sorts in registers
constexpr int CE = CHUNK / 32;        // ... 8 a lane
constexpr int RUN = 4096;             // rows up to this: sorted in a block
constexpr int TILE = 4096;            // merge and final-pass tile, in keys
constexpr int DEFRAG_THREADS = 512;   // blocks of the in-block sort
constexpr int NARROW_WARPS = 8;       // rows a block when D <= CHUNK
constexpr int TILE_THREADS = 256;     // count and write blocks
constexpr int RUN_SMEM = RUN * 8 + RUN / 32 * 4;  // under 48 KB
constexpr long long SENT = 0x7fffffffLL;  // dst field: not a valid entry

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

// Fill entries [from, to) of an output row with (-1, 0, 0); with `vec`
// (the row length is a multiple of 4, so rows start 16-byte aligned),
// 16-byte stores between the first and last multiples of 4.
template <typename WT>
__device__ __forceinline__ void fill_range(int* od, WT* ow, int* ot,
                                           int from, int to, bool vec,
                                           int t, int nt) {
  if (from >= to) return;
  int head = to, tail = to;
  if (vec) {
    head = (from + 3) & ~3;
    head = head < to ? head : to;
    tail = to & ~3;
    tail = tail > head ? tail : head;
  }
  for (int e = from + t; e < head; e += nt) {
    od[e] = -1;
    ow[e] = zero_w<WT>();
    ot[e] = 0;
  }
  typedef typename Vec4<WT>::T V;
  const V z{};  // all bits zero: +0.0
  for (int e = head + 4 * t; e < tail; e += 4 * nt) {
    *reinterpret_cast<int4*>(od + e) = make_int4(-1, -1, -1, -1);
    *reinterpret_cast<V*>(ow + e) = z;
    *reinterpret_cast<int4*>(ot + e) = make_int4(0, 0, 0, 0);
  }
  for (int e = tail + t; e < to; e += nt) {
    od[e] = -1;
    ow[e] = zero_w<WT>();
    ot[e] = 0;
  }
}

// Fill entries [from, D) of an output row of width D.
template <typename WT>
__device__ __forceinline__ void fill_empty(int* od, WT* ow, int* ot,
                                           int from, int D, int t, int nt) {
  fill_range(od, ow, ot, from, D, (D & 3) == 0, t, nt);
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

// ---- block helpers ---------------------------------------------------------

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

__host__ __device__ __forceinline__ int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// ---- compact_rows rows wider than HASH_MAX_D: bitonic sort ---------------

template <typename WT>
__global__ void compact_sort_kernel(const int* __restrict__ dst,
                                    const WT* __restrict__ w,
                                    const int* __restrict__ ts,
                                    const int* __restrict__ size, int D,
                                    int npad, int use_read_ts, int read_ts,
                                    int* __restrict__ odst,
                                    WT* __restrict__ ow,
                                    int* __restrict__ ots,
                                    int* __restrict__ ocnt) {
  extern __shared__ unsigned long long smem_raw[];
  long long* key = reinterpret_cast<long long*>(smem_raw);  // npad
  int* flag = reinterpret_cast<int*>(key + npad);            // npad
  __shared__ int wsum[32];

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int* rd = dst + row * D;
  const WT* rw = w + row * D;
  const int* rt = ts + row * D;
  int lim = size[row];
  lim = lim < 0 ? 0 : (lim > D ? D : lim);

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

  // the last entry of each dst run wins; keep it unless it is a tombstone,
  // flagged in descending position order
  for (int i = tid; i < npad; i += nt) {
    const long long k = key[i];
    if (k == LLONG_MAX) continue;
    const bool last = (i + 1 == npad) || ((key[i + 1] >> 32) != (k >> 32));
    const int pos = (int)(k & 0xffffffffLL);
    if (last && to_f(rw[pos]) != 0.0f) flag[npad - 1 - pos] = 1;
  }
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
    const int pos = npad - 1 - i;
    od[rank] = rd[pos];
    owr[rank] = rw[pos];
    ot[rank] = rt[pos];
  }
  fill_empty(od, owr, ot, total, D, tid, nt);
  if (tid == 0) ocnt[row] = total;
}

// ---- defrag_rows -----------------------------------------------------------

// The sort key of entry p of a row: dst << 32 | p when the entry is valid,
// else (and for padding past lim) SENT << 32 | p, above every valid key.
__device__ __forceinline__ long long entry_key(int d, int p) {
  const long long hi = (d >= 0 && d < BIGD) ? (long long)d : SENT;
  return (hi << 32) | (long long)(unsigned)p;
}
__device__ __forceinline__ long long pad_key(int p) {
  return (SENT << 32) | (long long)(unsigned)p;
}
__device__ __forceinline__ int key_dst(long long k) { return (int)(k >> 32); }
__device__ __forceinline__ int key_pos(long long k) {
  return (int)(unsigned)(k & 0xffffffffLL);
}

// One compare-exchange step of a bitonic network over a warp's 32 E keys,
// element i = base + 32 e + lane in v[e], at merge stage k2 and stride J.
template <int E, int J>
__device__ __forceinline__ void bstep(long long (&v)[E], int base, int k2,
                                      int lane) {
  if constexpr (J >= 32) {
    constexpr int JE = J / 32;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e & JE) == 0) {
        const bool up = ((base + e * 32 + lane) & k2) == 0;
        const long long a = v[e];
        const long long b = v[e + JE];
        if ((a > b) == up) {
          v[e] = b;
          v[e + JE] = a;
        }
      }
    }
  } else {
    const bool lower = (lane & J) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long o = __shfl_xor_sync(FULL, v[e], J);
      const bool up = ((base + e * 32 + lane) & k2) == 0;
      const bool take_min = lower == up;
      v[e] = take_min ? (v[e] < o ? v[e] : o) : (v[e] > o ? v[e] : o);
    }
  }
}

// Strides jmax, jmax / 2, ..., 1 of merge stage k2 (jmax < 32 E).
template <int E>
__device__ __forceinline__ void chunk_steps(long long (&v)[E], int base,
                                            int k2, int jmax, int lane) {
  if constexpr (E >= 8) {
    if (jmax >= 128) bstep<E, 128>(v, base, k2, lane);
  }
  if constexpr (E >= 4) {
    if (jmax >= 64) bstep<E, 64>(v, base, k2, lane);
  }
  if constexpr (E >= 2) {
    if (jmax >= 32) bstep<E, 32>(v, base, k2, lane);
  }
  if (jmax >= 16) bstep<E, 16>(v, base, k2, lane);
  if (jmax >= 8) bstep<E, 8>(v, base, k2, lane);
  if (jmax >= 4) bstep<E, 4>(v, base, k2, lane);
  if (jmax >= 2) bstep<E, 2>(v, base, k2, lane);
  bstep<E, 1>(v, base, k2, lane);
}

// The network's stages 2 .. kmax (default 32 E): each aligned chunk of
// kmax keys sorted, ascending or descending by (base & kmax), as the next
// stage needs. A warp's row of lim keys, padding after them, needs only
// the stages up to next_pow2(lim): its first block is then ascending, and
// every key past it is padding above every valid key.
template <int E>
__device__ __forceinline__ void chunk_sort(long long (&v)[E], int base,
                                           int lane, int kmax = 32 * E) {
  for (int k2 = 2; k2 <= kmax; k2 <<= 1)
    chunk_steps<E>(v, base, k2, k2 >> 1, lane);
}

// Whether sorted key i of n survives: a valid key is kept under keep_all;
// else it is kept when it is the last of its dst run (the last writer)
// and its weight is non-zero (`alive`, which `live` counts either way).
template <typename WT>
__device__ __forceinline__ bool key_keep(long long k, long long next,
                                         const WT* rw, int keep_all,
                                         bool* alive) {
  const int d = key_dst(k);
  const bool valid = d < BIGD;
  const bool last = valid && key_dst(next) != d;
  *alive = last && to_f(rw[key_pos(k)]) != 0.0f;
  return keep_all ? valid : *alive;
}

// A row of lim <= 32 E entries by one warp, in registers: writes the
// survivors to od / ow / ot [0, count) and returns count (every lane);
// *live gets the live count.
template <typename WT, int E>
__device__ int warp_row(const int* rd, const WT* rw, const int* rt, int lim,
                        int keep_all, int* od, WT* ow, int* ot, int* live) {
  const int lane = threadIdx.x & 31;
  long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < lim ? entry_key(rd[i], i) : pad_key(i);
  }
  chunk_sort<E>(v, 0, lane, next_pow2(lim));
  int run = 0, nlive = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    long long next = __shfl_down_sync(FULL, v[e], 1);
    const long long first_next =
        __shfl_sync(FULL, v[e + 1 < E ? e + 1 : e], 0);
    if (lane == 31) next = e + 1 < E ? first_next : LLONG_MAX;
    bool alive;
    const bool keep = key_keep(v[e], next, rw, keep_all, &alive);
    const unsigned bal = __ballot_sync(FULL, keep);
    if (keep) {
      const int r = run + __popc(bal & ((1u << lane) - 1));
      const int pos = key_pos(v[e]);
      od[r] = key_dst(v[e]);
      ow[r] = rw[pos];
      ot[r] = rt[pos];
    }
    run += __popc(bal);
    nlive += __popc(__ballot_sync(FULL, alive));
  }
  *live = nlive;
  return run;
}

// A row of lim <= 32 EMAX entries by one warp, its registers sized by lim.
template <typename WT, int EMAX = CE>
__device__ int warp_row_any(const int* rd, const WT* rw, const int* rt,
                            int lim, int keep_all, int* od, WT* ow, int* ot,
                            int* live) {
  if (EMAX == 1 || lim <= 32)
    return warp_row<WT, 1>(rd, rw, rt, lim, keep_all, od, ow, ot, live);
  if constexpr (EMAX >= 2) {
    if (EMAX == 2 || lim <= 64)
      return warp_row<WT, 2>(rd, rw, rt, lim, keep_all, od, ow, ot, live);
  }
  if constexpr (EMAX >= 4) {
    if (EMAX == 4 || lim <= 128)
      return warp_row<WT, 4>(rd, rw, rt, lim, keep_all, od, ow, ot, live);
  }
  if constexpr (EMAX >= 8)
    return warp_row<WT, 8>(rd, rw, rt, lim, keep_all, od, ow, ot, live);
  return 0;
}

// Sort keys of positions [lo, lo + n) of a row into key[0, npad) (npad a
// power of two >= max(n, 2 CHUNK)), ascending, padding past n. The warps
// of the block take chunks of 32 E keys in registers; of each stage past
// the chunk only strides >= 32 E go through shared memory.
template <int E>
__device__ void block_sort_keys_e(const int* rd, int lo, int n, int npad,
                                  long long* key) {
  constexpr int C = 32 * E;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nw = nt >> 5;
  const int nch = npad / C;
  for (int c = wid; c < nch; c += nw) {
    const int base = c * C;
    long long v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = base + e * 32 + lane;
      v[e] = i < n ? entry_key(rd[lo + i], lo + i) : pad_key(lo + i);
    }
    chunk_sort<E>(v, base, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) key[base + e * 32 + lane] = v[e];
  }
  __syncthreads();
  for (int k2 = 2 * C; k2 <= npad; k2 <<= 1) {
    for (int j = k2 >> 1; j >= C; j >>= 1) {
      for (int p = tid; p < (npad >> 1); p += nt) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const long long a = key[i];
        const long long b = key[i + j];
        if ((a > b) == ((i & k2) == 0)) {
          key[i] = b;
          key[i + j] = a;
        }
      }
      __syncthreads();
    }
    for (int c = wid; c < nch; c += nw) {
      const int base = c * C;
      long long v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = key[base + e * 32 + lane];
      chunk_steps<E>(v, base, k2, C / 2, lane);
#pragma unroll
      for (int e = 0; e < E; ++e) key[base + e * 32 + lane] = v[e];
    }
    __syncthreads();
  }
}

// The chunk as wide as keeps every warp busy (npad / warps keys), from 32
// to CHUNK keys.
__device__ void block_sort_keys(const int* rd, int lo, int n, int npad,
                                long long* key) {
  const int per_warp = npad / (int)(blockDim.x >> 5);
  if (per_warp <= 32)
    block_sort_keys_e<1>(rd, lo, n, npad, key);
  else if (per_warp <= 64)
    block_sort_keys_e<2>(rd, lo, n, npad, key);
  else if (per_warp <= 128)
    block_sort_keys_e<4>(rd, lo, n, npad, key);
  else
    block_sort_keys_e<CE>(rd, lo, n, npad, key);
}

// Rank and write the survivors of a row whose n keys are sorted in
// key[0, npad) (n > 0). Leaves count in s_tot[0] and live in s_tot[1].
template <typename WT>
__device__ void block_rank_write(const long long* key, int npad, int n,
                                 const WT* rw, const int* rt, int keep_all,
                                 unsigned* bal, int* s_cnt, int* s_tot,
                                 int* od, WT* ow, int* ot) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int nch = (n + CHUNK - 1) / CHUNK;
  if (tid == 0) s_tot[1] = 0;
  __syncthreads();
  for (int c = wid; c < nch; c += nw) {
    int cnt = 0, live = 0;
#pragma unroll
    for (int e = 0; e < CE; ++e) {
      const int i = c * CHUNK + e * 32 + lane;
      const long long next = i + 1 < npad ? key[i + 1] : LLONG_MAX;
      bool alive;
      const bool keep = key_keep(key[i], next, rw, keep_all, &alive);
      const unsigned b = __ballot_sync(FULL, keep);
      if (lane == 0) bal[i >> 5] = b;
      cnt += __popc(b);
      live += __popc(__ballot_sync(FULL, alive));
    }
    if (lane == 0) {
      s_cnt[c] = cnt;
      if (live) atomicAdd(&s_tot[1], live);
    }
  }
  __syncthreads();
  static_assert(RUN / CHUNK <= 64, "two chunk counts a lane");
  if (wid == 0) {  // exclusive scan of the chunk counts, two a lane
    const int a = 2 * lane < nch ? s_cnt[2 * lane] : 0;
    const int b = 2 * lane + 1 < nch ? s_cnt[2 * lane + 1] : 0;
    int x = a + b;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    const int excl = x - a - b;
    if (2 * lane < nch) s_cnt[2 * lane] = excl;
    if (2 * lane + 1 < nch) s_cnt[2 * lane + 1] = excl + a;
    if (lane == 31) s_tot[0] = x;
  }
  __syncthreads();
  for (int c = wid; c < nch; c += nw) {
    int run = s_cnt[c];
#pragma unroll
    for (int e = 0; e < CE; ++e) {
      const int i = c * CHUNK + e * 32 + lane;
      const unsigned b = bal[i >> 5];
      if ((b >> lane) & 1u) {
        const long long k = key[i];
        const int pos = key_pos(k);
        const int r = run + __popc(b & ((1u << lane) - 1));
        od[r] = key_dst(k);
        ow[r] = rw[pos];
        ot[r] = rt[pos];
      }
      run += __popc(b);
    }
  }
  __syncthreads();
}

// A whole row of lim <= RUN entries by the block (warp 0 alone when
// lim <= CHUNK): survivors written, count and live left in s_tot after a
// barrier. The caller fills the rest of the row.
template <typename WT>
__device__ void row_in_block(const int* rd, const WT* rw, const int* rt,
                             int lim, int keep_all, long long* key,
                             unsigned* bal, int* s_cnt, int* s_tot, int* od,
                             WT* ow, int* ot) {
  if (lim <= CHUNK) {
    if (threadIdx.x < 32) {
      int live = 0;
      const int cnt =
          warp_row_any(rd, rw, rt, lim, keep_all, od, ow, ot, &live);
      if (threadIdx.x == 0) {
        s_tot[0] = cnt;
        s_tot[1] = live;
      }
    }
    __syncthreads();
    return;
  }
  const int npad = next_pow2(lim);  // >= 2 CHUNK
  block_sort_keys(rd, 0, lim, npad, key);
  block_rank_write(key, npad, lim, rw, rt, keep_all, bal, s_cnt, s_tot, od,
                   ow, ot);
}

__device__ __forceinline__ int clamp_lim(const int* size, long long row,
                                         int D) {
  const int lim = size[row];
  return lim < 0 ? 0 : (lim > D ? D : lim);
}

// D <= CHUNK: one warp a row, NARROW_WARPS rows a block, nothing in
// shared memory; EMAX = next_pow2(D) / 32 keys a lane at most, so a
// narrow launch holds few registers and fills the SMs with warps.
template <typename WT, int EMAX>
__global__ void __launch_bounds__(NARROW_WARPS * 32)
    defrag_warp_kernel(const int* __restrict__ dst,
                       const WT* __restrict__ w,
                       const int* __restrict__ ts,
                       const int* __restrict__ size, long long K, int D,
                       int keep_all, int* __restrict__ odst,
                       WT* __restrict__ ow, int* __restrict__ ots,
                       int* __restrict__ ocnt, int* __restrict__ olive) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * NARROW_WARPS + (threadIdx.x >> 5);
  if (row >= K) return;  // the whole warp: one row each
  const int lim = clamp_lim(size, row, D);
  int* od = odst + row * D;
  WT* owr = ow + row * D;
  int* ot = ots + row * D;
  int live = 0;
  const int cnt = warp_row_any<WT, EMAX>(dst + row * D, w + row * D,
                                         ts + row * D, lim, keep_all, od,
                                         owr, ot, &live);
  fill_range(od, owr, ot, cnt, D, (D & 3) == 0, lane, 32);
  if (lane == 0) {
    ocnt[row] = cnt;
    olive[row] = live;
  }
}

// CHUNK < D <= RUN: rows_per_block rows a block, a warp each; rows past
// CHUNK entries then by the whole block, one after another. Dynamic shared
// memory: next_pow2(D) keys and a ballot word per 32.
template <typename WT>
__global__ void __launch_bounds__(DEFRAG_THREADS, 1)
    defrag_small_kernel(const int* __restrict__ dst,
                        const WT* __restrict__ w,
                        const int* __restrict__ ts,
                        const int* __restrict__ size, long long K, int D,
                        int rows_per_block, int npad_max, int keep_all,
                        int* __restrict__ odst, WT* __restrict__ ow,
                        int* __restrict__ ots, int* __restrict__ ocnt,
                        int* __restrict__ olive) {
  extern __shared__ long long skey[];
  unsigned* bal = reinterpret_cast<unsigned*>(skey + npad_max);
  __shared__ int big[32];
  __shared__ int nbig;
  __shared__ int s_cnt[RUN / CHUNK];
  __shared__ int s_tot[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const bool vec = (D & 3) == 0;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  if (tid == 0) nbig = 0;
  __syncthreads();
  if (wid < rows_per_block && row0 + wid < K) {
    const long long row = row0 + wid;
    const int lim = clamp_lim(size, row, D);
    if (lim <= CHUNK) {
      int* od = odst + row * D;
      WT* owr = ow + row * D;
      int* ot = ots + row * D;
      int live = 0;
      const int cnt = warp_row_any(dst + row * D, w + row * D, ts + row * D,
                                   lim, keep_all, od, owr, ot, &live);
      fill_range(od, owr, ot, cnt, D, vec, lane, 32);
      if (lane == 0) {
        ocnt[row] = cnt;
        olive[row] = live;
      }
    } else if (lane == 0) {
      big[atomicAdd(&nbig, 1)] = wid;
    }
  }
  __syncthreads();
  const int n_big = nbig;
  for (int b = 0; b < n_big; ++b) {
    const long long row = row0 + big[b];
    const int lim = clamp_lim(size, row, D);
    int* od = odst + row * D;
    WT* owr = ow + row * D;
    int* ot = ots + row * D;
    row_in_block(dst + row * D, w + row * D, ts + row * D, lim, keep_all,
                 skey, bal, s_cnt, s_tot, od, owr, ot);
    fill_range(od, owr, ot, s_tot[0], D, vec, tid, (int)blockDim.x);
    if (tid == 0) {
      ocnt[row] = s_tot[0];
      olive[row] = s_tot[1];
    }
    __syncthreads();  // s_tot and the shared keys are reused
  }
}

// D > RUN, pass 1: block (row, r) sorts positions [r RUN, (r + 1)
// RUN) of a row past RUN into runs[row]; a row of at most RUN
// entries is done whole by its block r = 0, and its other blocks fill
// their stretch of the output row.
template <typename WT>
__global__ void __launch_bounds__(DEFRAG_THREADS, 2)
    defrag_run_kernel(const int* __restrict__ dst, const WT* __restrict__ w,
                      const int* __restrict__ ts,
                      const int* __restrict__ size, int D, int nrun,
                      int keep_all, int* __restrict__ odst,
                      WT* __restrict__ ow, int* __restrict__ ots,
                      int* __restrict__ ocnt, int* __restrict__ olive,
                      long long* __restrict__ runs) {
  extern __shared__ long long skey[];
  unsigned* bal = reinterpret_cast<unsigned*>(skey + RUN);
  __shared__ int s_cnt[RUN / CHUNK];
  __shared__ int s_tot[2];
  const long long row = blockIdx.x / nrun;
  const int r = (int)(blockIdx.x % nrun);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lim = clamp_lim(size, row, D);
  const int lo = r * RUN;
  const int* rd = dst + row * D;
  if (lim <= RUN) {
    int* od = odst + row * D;
    WT* owr = ow + row * D;
    int* ot = ots + row * D;
    const int hi = D - lo > RUN ? lo + RUN : D;
    const bool vec = (D & 3) == 0;
    if (r > 0) {
      fill_range(od, owr, ot, lo, hi, vec, tid, nt);
      return;
    }
    row_in_block(rd, w + row * D, ts + row * D, lim, keep_all, skey, bal,
                 s_cnt, s_tot, od, owr, ot);
    fill_range(od, owr, ot, s_tot[0], hi, vec, tid, nt);
    if (tid == 0) {
      ocnt[row] = s_tot[0];
      olive[row] = s_tot[1];
    }
    return;
  }
  if (lo >= lim) return;
  const int n = lim - lo > RUN ? RUN : lim - lo;
  block_sort_keys(rd, lo, n, next_pow2(n > 2 * CHUNK ? n : 2 * CHUNK), skey);
  long long* out = runs + row * D + lo;
  for (int i = tid; i < n; i += nt) out[i] = skey[i];
}

// How many of A's first elements are among the first k of merge(A, B)
// (keys distinct).
__device__ int merge_path(const long long* A, int la, const long long* B,
                          int lb, int k) {
  int lo = k - lb > 0 ? k - lb : 0;
  int hi = k < la ? k : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (A[mid] < B[k - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Elements of sorted a[0, n) below x.
__device__ __forceinline__ int count_less(const long long* a, int n,
                                          long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One merge pass over rows past RUN: sorted runs of width `run` in
// src (positions [0, lim) of each row) merged pairwise into out. Block
// (row, t) makes outputs [t TILE, (t + 1) TILE) of its pair (TILE divides
// 2 run, so a tile never spans two pairs).
__global__ void __launch_bounds__(DEFRAG_THREADS, 1)
    defrag_merge_kernel(const long long* __restrict__ src,
                        long long* __restrict__ out,
                        const int* __restrict__ size, int D, int ntile,
                        long long run) {
  __shared__ long long sm[TILE];
  __shared__ int s_a[2];
  const long long row = blockIdx.x / ntile;
  const long long o0 = (long long)(blockIdx.x % ntile) * TILE;
  const int lim = clamp_lim(size, row, D);
  if (lim <= RUN || o0 >= lim) return;
  const long long s = o0 / (2 * run) * (2 * run);
  const int la = (int)(lim - s < run ? lim - s : run);
  const int lb = (int)(lim - s - la < run ? lim - s - la : run);
  const long long* A = src + row * D + s;
  const long long* B = A + la;
  const int k0 = (int)(o0 - s);
  const int k1 = k0 + TILE < la + lb ? k0 + TILE : la + lb;
  if (threadIdx.x < 2)
    s_a[threadIdx.x] = merge_path(A, la, B, lb, threadIdx.x ? k1 : k0);
  __syncthreads();
  const int a0 = s_a[0], a1 = s_a[1];
  const int b0 = k0 - a0;
  const int na = a1 - a0, nb = (k1 - a1) - b0;
  for (int i = threadIdx.x; i < na; i += blockDim.x) sm[i] = A[a0 + i];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sm[na + i] = B[b0 + i];
  __syncthreads();
  long long* o = out + row * D + s + k0;
  for (int i = threadIdx.x; i < na + nb; i += blockDim.x) {
    const long long x = sm[i];
    const int rank = i < na ? i + count_less(sm + na, nb, x)
                            : (i - na) + count_less(sm, na, x);
    o[rank] = x;
  }
}

// Rows past RUN, sorted in keys: kept and live entries per tile.
template <typename WT>
__global__ void __launch_bounds__(TILE_THREADS)
    defrag_count_kernel(const long long* __restrict__ keys,
                        const WT* __restrict__ w,
                        const int* __restrict__ size, int D, int ntile,
                        int keep_all, int* __restrict__ tcnt,
                        int* __restrict__ tlive) {
  __shared__ int wsum[32];
  const long long row = blockIdx.x / ntile;
  const int t = (int)(blockIdx.x % ntile);
  const int lim = clamp_lim(size, row, D);
  if (lim <= RUN) return;
  const long long* rk = keys + row * D;
  const WT* rw = w + row * D;
  const int lo = t * TILE;
  const int hi = lim - lo < TILE ? lim : lo + TILE;
  int c = 0, l = 0;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    bool alive;
    c += key_keep(rk[i], i + 1 < lim ? rk[i + 1] : LLONG_MAX, rw, keep_all,
                  &alive);
    l += alive;
  }
  int tc = 0, tl = 0;
  block_exclusive_scan(c, wsum, &tc);
  block_exclusive_scan(l, wsum, &tl);
  if (threadIdx.x == 0) {
    tcnt[row * ntile + t] = tc;
    tlive[row * ntile + t] = tl;
  }
}

// Rows past RUN: tile counts -> exclusive tile offsets (in place);
// count and live of the row.
__global__ void __launch_bounds__(TILE_THREADS)
    defrag_scan_kernel(const int* __restrict__ size, int D, int ntile,
                       int* __restrict__ tcnt,
                       const int* __restrict__ tlive,
                       int* __restrict__ ocnt, int* __restrict__ olive) {
  __shared__ int wsum[32];
  const long long row = blockIdx.x;
  const int lim = clamp_lim(size, row, D);
  if (lim <= RUN) return;
  int* c = tcnt + row * ntile;
  const int* l = tlive + row * ntile;
  int carry = 0, lsum = 0;
  for (int base = 0; base < ntile; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < ntile ? c[i] : 0;
    lsum += i < ntile ? l[i] : 0;
    int total = 0;
    const int ex = block_exclusive_scan(v, wsum, &total);
    if (i < ntile) c[i] = carry + ex;
    carry += total;
  }
  int live = 0;
  block_exclusive_scan(lsum, wsum, &live);
  if (threadIdx.x == 0) {
    ocnt[row] = carry;
    olive[row] = live;
  }
}

// Rows past RUN: each tile's survivors to their rank, and the tile's
// stretch of the output row past the count filled. Each thread takes
// TILE / TILE_THREADS consecutive keys.
template <typename WT>
__global__ void __launch_bounds__(TILE_THREADS)
    defrag_write_kernel(const long long* __restrict__ keys,
                        const WT* __restrict__ w,
                        const int* __restrict__ ts,
                        const int* __restrict__ size, int D, int ntile,
                        int keep_all, const int* __restrict__ toff,
                        const int* __restrict__ ocnt, int* __restrict__ odst,
                        WT* __restrict__ ow, int* __restrict__ ots) {
  constexpr int PER = TILE / TILE_THREADS;
  static_assert(PER <= 32, "one keep bit a key in a 32-bit mask");
  __shared__ int wsum[32];
  const long long row = blockIdx.x / ntile;
  const int t = (int)(blockIdx.x % ntile);
  const int lim = clamp_lim(size, row, D);
  if (lim <= RUN) return;
  const long long* rk = keys + row * D;
  const WT* rw = w + row * D;
  const int* rt = ts + row * D;
  const int lo = t * TILE;
  const int hi = lim - lo < TILE ? lim : lo + TILE;
  const int i0 = lo + threadIdx.x * PER;
  unsigned mask = 0;
  int c = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = i0 + q;
    if (i < hi) {
      bool alive;
      if (key_keep(rk[i], i + 1 < lim ? rk[i + 1] : LLONG_MAX, rw, keep_all,
                   &alive)) {
        mask |= 1u << q;
        ++c;
      }
    }
  }
  int total = 0;
  int r = toff[row * ntile + t] + block_exclusive_scan(c, wsum, &total);
  int* od = odst + row * D;
  WT* owr = ow + row * D;
  int* ot = ots + row * D;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if ((mask >> q) & 1u) {
      const long long k = rk[i0 + q];
      const int pos = key_pos(k);
      od[r] = key_dst(k);
      owr[r] = rw[pos];
      ot[r] = rt[pos];
      ++r;
    }
  }
  const int count = ocnt[row];
  const int hi_out = D - lo < TILE ? D : lo + TILE;
  fill_range(od, owr, ot, count > lo ? count : lo, hi_out, (D & 3) == 0,
             (int)threadIdx.x, (int)blockDim.x);
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

template <typename WT>
static int launch_compact_sort(const int* dst, const WT* w, const int* ts,
                               const int* size, int K, int D,
                               int use_read_ts, int read_ts, int* odst,
                               WT* ow, int* ots, int* ocnt, void* stream) {
  static unsigned done = 0;
  const int npad = next_pow2(D > 32 ? D : 32);
  const int threads = npad < 512 ? npad : 512;
  const size_t smem = (size_t)npad * (sizeof(long long) + sizeof(int));
  const int err = ensure_smem(compact_sort_kernel<WT>, SORT_MAX_SMEM, &done);
  if (err) return err;
  compact_sort_kernel<WT><<<K, threads, smem, (cudaStream_t)stream>>>(
      dst, w, ts, size, D, npad, use_read_ts, read_ts, odst, ow, ots, ocnt);
  return (int)cudaGetLastError();
}

template <typename WT>
static int launch_defrag(const int* dst, const WT* w, const int* ts,
                         const int* size, int K, int D, int keep_all,
                         int* odst, WT* ow, int* ots, int* ocnt, int* olive,
                         long long* keys, int* tiles, int* nlaunch,
                         cudaStream_t st) {
  int err = 0;
  if (D <= CHUNK) {
    const unsigned blocks = (unsigned)((K + NARROW_WARPS - 1) / NARROW_WARPS);
    const int threads = NARROW_WARPS * 32;
    if (D <= 32)
      defrag_warp_kernel<WT, 1><<<blocks, threads, 0, st>>>(
          dst, w, ts, size, K, D, keep_all, odst, ow, ots, ocnt, olive);
    else if (D <= 64)
      defrag_warp_kernel<WT, 2><<<blocks, threads, 0, st>>>(
          dst, w, ts, size, K, D, keep_all, odst, ow, ots, ocnt, olive);
    else if (D <= 128)
      defrag_warp_kernel<WT, 4><<<blocks, threads, 0, st>>>(
          dst, w, ts, size, K, D, keep_all, odst, ow, ots, ocnt, olive);
    else
      defrag_warp_kernel<WT, CE><<<blocks, threads, 0, st>>>(
          dst, w, ts, size, K, D, keep_all, odst, ow, ots, ocnt, olive);
    ++*nlaunch;
    return (int)cudaGetLastError();
  }
  if (D <= RUN) {
    int sms = 0;
    if ((err = sm_count(&sms))) return err;
    // few rows a block (each block holds one sort buffer), as in
    // launch_hash
    const long long per = (long long)BLOCKS_PER_SM * sms;
    const int nw = DEFRAG_THREADS / 32;
    long long rpb = (K + per - 1) / per;
    rpb = rpb < 1 ? 1 : (rpb > nw ? nw : rpb);
    const int npad = next_pow2(D);
    const size_t smem = (size_t)npad * 8 + (size_t)npad / 32 * 4;
    defrag_small_kernel<WT><<<(unsigned)((K + rpb - 1) / rpb),
                              DEFRAG_THREADS, smem, st>>>(
        dst, w, ts, size, K, D, (int)rpb, npad, keep_all, odst, ow, ots,
        ocnt, olive);
    ++*nlaunch;
    return (int)cudaGetLastError();
  }
  const int nrun = (D + RUN - 1) / RUN;
  const int ntile = (D + TILE - 1) / TILE;
  if ((long long)K * ntile > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned runs = (unsigned)K * nrun, tiled = (unsigned)K * ntile;
  long long* src = keys;
  long long* out = keys + (long long)K * D;
  defrag_run_kernel<WT><<<runs, DEFRAG_THREADS, RUN_SMEM, st>>>(
      dst, w, ts, size, D, nrun, keep_all, odst, ow, ots, ocnt, olive, src);
  ++*nlaunch;
  if ((err = (int)cudaGetLastError())) return err;
  for (long long run = RUN; run < D; run *= 2) {
    defrag_merge_kernel<<<tiled, DEFRAG_THREADS, 0, st>>>(src, out, size, D,
                                                          ntile, run);
    ++*nlaunch;
    if ((err = (int)cudaGetLastError())) return err;
    long long* tmp = src;
    src = out;
    out = tmp;
  }
  int* tcnt = tiles;
  int* tlive = tiles + (long long)K * ntile;
  defrag_count_kernel<WT><<<tiled, TILE_THREADS, 0, st>>>(
      src, w, size, D, ntile, keep_all, tcnt, tlive);
  ++*nlaunch;
  if ((err = (int)cudaGetLastError())) return err;
  defrag_scan_kernel<<<(unsigned)K, TILE_THREADS, 0, st>>>(
      size, D, ntile, tcnt, tlive, ocnt, olive);
  ++*nlaunch;
  if ((err = (int)cudaGetLastError())) return err;
  defrag_write_kernel<WT><<<tiled, TILE_THREADS, 0, st>>>(
      src, w, ts, size, D, ntile, keep_all, tcnt, ocnt, odst, ow, ots);
  ++*nlaunch;
  return (int)cudaGetLastError();
}

// compact_rows. wdtype: 0 = float32, 1 = bfloat16. D <= MAX_ROW_WIDTH
// (16384).
extern "C" int compact_launch(int wdtype, const int* dst, const void* w,
                              const int* ts, const int* size, int K, int D,
                              int use_read_ts, int read_ts, int* odst,
                              void* ow, int* ots, int* ocnt, void* stream) {
  if (K <= 0 || D <= 0) return 0;
  if (wdtype == 0) {
    if (D <= HASH_MAX_D)
      return launch_hash<float>(dst, (const float*)w, ts, size, K, D,
                                use_read_ts, read_ts, odst, (float*)ow, ots,
                                ocnt, stream);
    return launch_compact_sort<float>(dst, (const float*)w, ts, size, K, D,
                                      use_read_ts, read_ts, odst, (float*)ow,
                                      ots, ocnt, stream);
  }
  typedef __nv_bfloat16 B;
  if (D <= HASH_MAX_D)
    return launch_hash<B>(dst, (const B*)w, ts, size, K, D, use_read_ts,
                          read_ts, odst, (B*)ow, ots, ocnt, stream);
  return launch_compact_sort<B>(dst, (const B*)w, ts, size, K, D,
                                use_read_ts, read_ts, odst, (B*)ow, ots,
                                ocnt, stream);
}

// Scratch a defrag_rows launch needs: int64 keys and int32 tile counts
// (none for D <= RUN).
extern "C" void defrag_scratch(int K, int D, long long* key_elems,
                               long long* tile_elems) {
  const bool wide = K > 0 && D > RUN;
  const long long ntile = (D + TILE - 1) / TILE;
  *key_elems = wide ? 2LL * K * D : 0;
  *tile_elems = wide ? 2LL * K * ntile : 0;
}

// wdtype: 0 = float32, 1 = bfloat16. Any D; keys / tiles as
// defrag_scratch sizes them. *nlaunch gets the kernels launched.
extern "C" int defrag_launch(int wdtype, const int* dst, const void* w,
                             const int* ts, const int* size, int K, int D,
                             int keep_all, int* odst, void* ow, int* ots,
                             int* ocnt, int* olive, long long* keys,
                             long long key_elems, int* tiles,
                             long long tile_elems, int* nlaunch,
                             void* stream) {
  *nlaunch = 0;
  if (K <= 0 || D <= 0) return 0;
  long long need_keys = 0, need_tiles = 0;
  defrag_scratch(K, D, &need_keys, &need_tiles);
  if (key_elems < need_keys || tile_elems < need_tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (wdtype == 0)
    return launch_defrag<float>(dst, (const float*)w, ts, size, K, D,
                                keep_all, odst, (float*)ow, ots, ocnt, olive,
                                keys, tiles, nlaunch, st);
  typedef __nv_bfloat16 B;
  return launch_defrag<B>(dst, (const B*)w, ts, size, K, D, keep_all, odst,
                          (B*)ow, ots, ocnt, olive, keys, tiles, nlaunch, st);
}
