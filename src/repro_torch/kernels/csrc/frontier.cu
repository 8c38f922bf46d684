// BFS frontier expansion for Hopper (sm_90a): one level over a flat edge
// array, as bitmaps of 32-bit words.
//
// Replaces the TPU kernel `frontier_pallas` / `_kernel` in
// src/repro/kernels/frontier.py. It computes the oracle `frontier_ref` in
// src/repro/kernels/ref.py, not the Pallas grid: the TPU kernel keeps the
// output bitmap in one block that every sequential grid step revisits,
// which CUDA blocks (parallel, unordered) cannot do. Here every entry ORs
// its bit straight into the output in device memory with an atomic.
//
//   out[w] = OR over entries (b, j) with valid[b, j], 0 <= dst < 32 W,
//            owner[b] >= 0 and frontier bit min(owner[b], 32 W - 1) set,
//            of bit dst[b, j]  ... then AND NOT visited[w].
//
// Edge rules follow the oracle: an owner above 32 W - 1 is clipped to the
// last bit, an owner below 0 never expands, a destination outside
// [0, 32 W) is dropped (a JAX scatter drops out-of-range indices). The
// Pallas kernel reads and writes out of bounds in those cases.
//
// What bounds it on the H100: bytes. Each entry reads owner (4 B), dst
// (4 B) and valid (1 B), about 9 B an entry; the frontier, visited and
// output bitmaps are 12 B a word. At m_cap = 2^23 entries and n_cap =
// 2^23 vertices (W = 2^18) that is about 78 MB, about 23 us at 3.35 TB/s. The second limit is atomic contention: every edge
// into a hub destination ORs into one word.
//
// Design (simple first): the caller zeroes `out`; one thread per (block,
// lane) entry, grid-stride. A thread reads its block's frontier word and
// tests its owner's bit, and only then loads dst and the destination's
// visited word; masking ~visited before the atomic is the same function
// as masking afterwards and saves a pass and the atomics into visited
// vertices. A later design would aggregate a warp's ORs into one word
// with __match_any_sync before the atomic, and keep tiles of the output
// bitmap in shared memory; the whole bitmap (1 MiB at n_cap = 2^23) does
// not fit in a block's 227 KB, so that needs destination tiling.
#include <cuda_runtime.h>

__global__ void frontier_kernel(const int* __restrict__ owner,
                                const int* __restrict__ dst,
                                const unsigned char* __restrict__ valid,
                                const unsigned* __restrict__ fbits,
                                const unsigned* __restrict__ vbits,
                                unsigned* __restrict__ out, long long n_blocks,
                                int block_size, int words) {
  const long long total = n_blocks * (long long)block_size;
  const long long nbits = 32LL * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += stride) {
    if (!valid[i]) continue;
    const int o = __ldg(owner + i / block_size);
    if (o < 0) continue;
    const long long oc = o < nbits ? (long long)o : nbits - 1;
    if (!((__ldg(fbits + (oc >> 5)) >> (oc & 31)) & 1u)) continue;
    const int d = dst[i];
    if (d < 0 || (long long)d >= nbits) continue;
    const unsigned bit = 1u << (d & 31);
    if (__ldg(vbits + (d >> 5)) & bit) continue;
    atomicOr(out + (d >> 5), bit);
  }
}

extern "C" int frontier_launch(const int* owner, const int* dst,
                               const unsigned char* valid,
                               const unsigned* fbits, const unsigned* vbits,
                               unsigned* out, long long n_blocks,
                               int block_size, int words, void* stream) {
  if (n_blocks < 0 || block_size < 0 || words <= 0)
    return (int)cudaErrorInvalidValue;
  const long long total = n_blocks * (long long)block_size;
  if (total == 0) return 0;
  const int threads = 256;
  long long grid = (total + threads - 1) / threads;
  if (grid > (1LL << 20)) grid = 1LL << 20;  // grid-stride past this
  frontier_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      owner, dst, valid, fbits, vbits, out, n_blocks, block_size, words);
  return (int)cudaGetLastError();
}
