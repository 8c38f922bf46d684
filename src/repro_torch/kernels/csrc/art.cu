// Batched ART insert for Hopper (sm_90a): the whole batch of keys in one
// launch, applied in batch order to the adaptive radix tree's arrays.
//
// Replaces no TPU kernel: it ports the JAX function `_art_insert` of
// src/repro/baselines/art.py, a `lax.scan` over the keys (one structural
// change per key: store into a dense node, take a free sparse slot, or
// metamorphose a full sparse node into a dense one and migrate its 16
// entries). Its plain PyTorch version is `art_insert_plain` in
// src/repro_torch/kernels/art.py; both write the same `ArtState` tensors
// bit for bit.
//
// What bounds it on the H100: the chain of dependent loads. Key k+1's walk
// may read what key k wrote (a node created, a slot taken, a node turned
// dense), so the keys cannot run in parallel; each layer of a key costs a
// few dependent loads (the node's dense row, its sparse key row, a child),
// most of them misses into arrays of gigabytes at LiveJournal scale.
//
// Design: one thread walks every key in order and keeps the node and dense
// row counters in registers, written back once at the end. Nothing that
// the kernel writes is read through the read-only cache, so each load sees
// the thread's own earlier stores. A sparse row's 16 keys are read as four
// 16-byte loads. The per-layer arrays are passed by value as device
// pointers with their capacities (layers <= 8), as in sort_lookup.cu. It
// replaces a host loop of tens of launches a key with one launch; it is
// not meant to be fast.
#include <cuda_runtime.h>

#define MAX_LAYERS 8
#define SPARSE_CAP 16
#define DENSE_FAN 256

struct ArtArgs {
  int* skeys[MAX_LAYERS];     // int32[cap_s, 16] radix bytes, -1 empty
  int* schild[MAX_LAYERS];    // int32[cap_s, 16] child node id / offset
  int* dense_of[MAX_LAYERS];  // int32[cap_s] dense row of a node, -1 sparse
  int* dchild[MAX_LAYERS];    // int32[cap_d, 256]
  long long cap_s[MAX_LAYERS];
  long long cap_d[MAX_LAYERS];
  int layers;
};

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void art_insert_kernel(ArtArgs a, const int* __restrict__ radix,
                                  const int* __restrict__ offsets,
                                  long long B, int* scount, int* dcount,
                                  int* overflow) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const int L = a.layers;
  int sc[MAX_LAYERS], dc[MAX_LAYERS];
  for (int i = 0; i < MAX_LAYERS; ++i) {
    sc[i] = i < L ? scount[i] : 0;
    dc[i] = i < L ? dcount[i] : 0;
  }
  int ovf = overflow[0];
  for (long long k = 0; k < B; ++k) {
    const int off = __ldg(offsets + k);
    long long node = 0;
    bool alive = true;
    for (int i = 0; i < L; ++i) {
      const int b = __ldg(radix + k * L + i);
      const long long cap_s = a.cap_s[i];
      const long long cap_d = a.cap_d[i];
      const long long nc = clampll(node, 0, cap_s - 1);
      const int drow = a.dense_of[i][nc];
      const bool is_dense = drow >= 0;
      const long long drc = clampll(drow, 0, cap_d - 1);
      int* skrow = a.skeys[i] + nc * SPARSE_CAP;
      int* schrow = a.schild[i] + nc * SPARSE_CAP;
      int sk[SPARSE_CAP];
      const int4* sk4 = reinterpret_cast<const int4*>(skrow);
#pragma unroll
      for (int q = 0; q < SPARSE_CAP / 4; ++q) {
        const int4 v = sk4[q];
        sk[4 * q] = v.x;
        sk[4 * q + 1] = v.y;
        sk[4 * q + 2] = v.z;
        sk[4 * q + 3] = v.w;
      }
      // first hit and first free slot (jnp.argmax of a bool row: the
      // first true, 0 when none)
      int pos = 0, fpos = 0;
      bool has_s = false, has_free = false;
#pragma unroll
      for (int j = SPARSE_CAP - 1; j >= 0; --j) {
        if (sk[j] == b) { has_s = true; pos = j; }
        if (sk[j] == -1) { has_free = true; fpos = j; }
      }
      int* dslot = a.dchild[i] + drc * DENSE_FAN + b;
      const int child = is_dense ? *dslot : (has_s ? schrow[pos] : -1);
      bool need = alive && child < 0;
      int new_child;
      if (i == L - 1) {
        new_child = off;
      } else {
        const bool fits_s = sc[i + 1] < a.cap_s[i + 1];
        new_child = fits_s ? sc[i + 1] : -1;
        if (need && fits_s) sc[i + 1] += 1;
        if (need && !fits_s) ovf += 1;
        need = need && fits_s;
      }
      if (need && is_dense) {                 // case A: dense store
        *dslot = new_child;
      } else if (need && has_free) {          // case B: free sparse slot
        skrow[fpos] = b;
        schrow[fpos] = new_child;
      } else if (need) {                      // case C: metamorphose
        const int new_did = dc[i];
        if (new_did < cap_d) {
          int* drow_p = a.dchild[i] + (long long)new_did * DENSE_FAN;
          for (int j = 0; j < SPARSE_CAP; ++j)
            if (sk[j] >= 0) drow_p[sk[j]] = schrow[j];
          drow_p[b] = new_child;
          a.dense_of[i][nc] = new_did;
          dc[i] = new_did + 1;
        } else {
          ovf += 1;
        }
      }
      alive = alive && (need ? new_child >= 0 : child >= 0);
      const int nxt = need ? new_child : child;
      node = nxt > 0 ? nxt : 0;
    }
  }
  for (int i = 0; i < L; ++i) {
    scount[i] = sc[i];
    dcount[i] = dc[i];
  }
  overflow[0] = ovf;
}

extern "C" int art_insert_launch(void* const* skeys, void* const* schild,
                                 void* const* dense_of, void* const* dchild,
                                 const long long* cap_s,
                                 const long long* cap_d, int layers,
                                 const int* radix, const int* offsets,
                                 long long B, int* scount, int* dcount,
                                 int* overflow, void* stream) {
  if (layers < 1 || layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  ArtArgs a;
  for (int i = 0; i < MAX_LAYERS; ++i) {
    const bool on = i < layers;
    a.skeys[i] = on ? (int*)skeys[i] : nullptr;
    a.schild[i] = on ? (int*)schild[i] : nullptr;
    a.dense_of[i] = on ? (int*)dense_of[i] : nullptr;
    a.dchild[i] = on ? (int*)dchild[i] : nullptr;
    a.cap_s[i] = on ? cap_s[i] : 0;
    a.cap_d[i] = on ? cap_d[i] : 0;
  }
  a.layers = layers;
  art_insert_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      a, radix, offsets, B, scount, dcount, overflow);
  return (int)cudaGetLastError();
}
