// Fused SORT descent for Hopper (sm_90a): (B, 2) [hi, lo] keys -> int32
// vertex-table offsets (-1 = absent).
//
// Replaces the TPU kernel `sort_lookup_pallas` / `_make_kernel` in
// src/repro/kernels/sort_lookup.py (oracle: `sort_lookup_ref` in
// src/repro/kernels/ref.py, identical to `repro.core.sort.lookup`).
//
// What bounds it on the H100: dependent-load latency, not bandwidth. Each
// key runs `l` gathers, each one's address depending on the previous
// result, into node pools of hundreds of megabytes (random 4-byte reads,
// one DRAM round trip each); the bytes moved are tiny beside the card's
// rate.
//
// Design: one thread per key keeps the whole descent in registers — no
// per-layer node vector goes back to device memory between layers, which
// is what the plain version does. Many keys in flight (one thread each,
// B = 8192 on ingest) hide part of the latency. The per-layer pools are
// passed by value as an array of device pointers together with their
// sizes, fan-out bits and bit offsets (l <= 8) in the kernel's argument
// block, so the launch needs no device-side table.
#include <cuda_runtime.h>

#define MAX_LAYERS 8

struct LookupArgs {
  const int* pools[MAX_LAYERS];
  long long sizes[MAX_LAYERS];
  int bits[MAX_LAYERS];
  int offs[MAX_LAYERS];
  int layers;
};

__global__ void sort_lookup_kernel(const long long* __restrict__ keys,
                                   int* __restrict__ out, int B,
                                   LookupArgs a) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= B) return;
  const unsigned long long hi = (unsigned long long)keys[2LL * k];
  const unsigned long long lo = (unsigned long long)keys[2LL * k + 1];
  long long node = 0;
  bool valid = true;
  for (int i = 0; i < a.layers; ++i) {
    const int bits = a.bits[i];
    const int boff = a.offs[i];
    const unsigned long long mask = (1ull << bits) - 1ull;
    unsigned long long idx;
    if (bits == 0) {
      idx = 0;
    } else if (boff >= 32) {
      idx = (hi >> (boff - 32)) & mask;
    } else if (boff + bits <= 32) {
      idx = (lo >> boff) & mask;
    } else {  // spans the word boundary
      const unsigned long long high_part =
          hi & ((1ull << (boff + bits - 32)) - 1ull);
      idx = (high_part << (32 - boff)) | (lo >> boff);
    }
    long long slot = node * (1ll << bits) + (long long)idx;
    slot = slot < 0 ? 0 : (slot >= a.sizes[i] ? a.sizes[i] - 1 : slot);
    const int child = valid ? __ldg(a.pools[i] + slot) : -1;
    valid = child >= 0;
    node = child > 0 ? child : 0;
  }
  out[k] = valid ? (int)node : -1;
}

extern "C" int sort_lookup_launch(const long long* keys, int* out, int B,
                                  const void* const* pools,
                                  const long long* sizes, const int* bits,
                                  const int* offs, int layers, void* stream) {
  if (layers < 1 || layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  LookupArgs a;
  for (int i = 0; i < MAX_LAYERS; ++i) {
    const bool on = i < layers;
    a.pools[i] = on ? (const int*)pools[i] : nullptr;
    a.sizes[i] = on ? sizes[i] : 0;
    a.bits[i] = on ? bits[i] : 0;
    a.offs[i] = on ? offs[i] : 0;
  }
  a.layers = layers;
  sort_lookup_kernel<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      keys, out, B, a);
  return (int)cudaGetLastError();
}
