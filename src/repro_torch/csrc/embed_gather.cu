// Row gather from the precomputed first-layer table: out[i, :] = table[ids[i], :].
//
// Replaces the Pallas TPU kernel src/repro/kernels/embed_gather.py
// (embed_gather / _gather_kernel), which DMAs one scalar-prefetched row per
// grid step. The paper's point is that this is the whole of layer 0 at run
// time: one row read per token.
//
// Bound: bytes. The kernel does no arithmetic; it moves N rows in and N rows
// out (N * row_bytes * 2). At the mistral-7b width a row is 10240 bf16 =
// 20 KB.
//
// Design: each row is split over blocks, grid (N rows, row chunks of
// kThreads * kUnroll vectors: 4 KB with 16-byte vectors), so at decode sizes
// (N 1-4) a row's bytes are read by many SMs at once rather than by one warp
// in dependent rounds. Each lane issues all its loads (kUnroll of 16 bytes)
// before its stores; neighbouring lanes touch neighbouring addresses, so
// reads and writes are coalesced. Rows whose byte width or base address is
// not a multiple of 16 take 4-byte, then 1-byte, vectors (same structure).
// The copy is a bit copy, so the result equals table[ids] bitwise for every
// dtype. Ids follow jnp.take, as the JAX table read does: an id in
// [-vocab, 0) reads row id + vocab; an id outside [-vocab, vocab) reads
// nothing and yields a row of NaN, the caller's 32-bit pattern of NaNs of
// the table's dtype repeated (the plain version's bits).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;
constexpr long long kChunk = kThreads * kUnroll;  // vectors of a block

// a vector of the repeated NaN pattern; the byte vector takes the pattern's
// byte at its offset (rows start at multiples of the element size, and the
// pattern repeats every element)
template <typename V> __device__ __forceinline__ V nan_fill(unsigned w, long long c);
template <> __device__ __forceinline__ uint4 nan_fill<uint4>(unsigned w, long long) {
  return make_uint4(w, w, w, w);
}
template <> __device__ __forceinline__ uint32_t nan_fill<uint32_t>(unsigned w, long long) {
  return w;
}
template <> __device__ __forceinline__ uint8_t nan_fill<uint8_t>(unsigned w, long long c) {
  return (uint8_t)(w >> (8 * (c & 3)));
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows(const V* __restrict__ table, const int* __restrict__ ids, V* __restrict__ out,
            int vocab, long long row_vecs, unsigned nan_word) {
  const long long row = blockIdx.x;
  const long long c0 = blockIdx.y * kChunk + threadIdx.x;
  int id = ids[row];
  V* dst = out + row * row_vecs;
  if (id < -vocab || id >= vocab) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + u * kThreads;
      if (c < row_vecs) dst[c] = nan_fill<V>(nan_word, c);
    }
    return;
  }
  if (id < 0) id += vocab;
  const V* src = table + (long long)id * row_vecs;
  V buf[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (c0 + u * kThreads < row_vecs) buf[u] = src[c0 + u * kThreads];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (c0 + u * kThreads < row_vecs) dst[c0 + u * kThreads] = buf[u];
}

template <typename V>
cudaError_t launch(const void* table, const int* ids, void* out, int n, int vocab,
                   long long row_bytes, unsigned nan_word, cudaStream_t stream) {
  const long long row_vecs = row_bytes / (long long)sizeof(V);
  const long long chunks = (row_vecs + kChunk - 1) / kChunk;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  if (chunks == 0) return cudaSuccess;
  gather_rows<V><<<dim3(n, (unsigned)chunks), kThreads, 0, stream>>>(
      static_cast<const V*>(table), ids, static_cast<V*>(out), vocab, row_vecs, nan_word);
  return cudaGetLastError();
}

bool aligned(const void* p, long long bytes, int to) {
  return (reinterpret_cast<uintptr_t>(p) % to) == 0 && bytes % to == 0;
}

}  // namespace

// nan_word: the 32-bit pattern of NaNs of the table's dtype (0x7FC00000
// for float32, 0x7FC07FC0 for bfloat16).
extern "C" int embed_gather(const void* table, const void* ids, void* out, int n,
                            int vocab, long long row_bytes, int nan_word, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const unsigned w = static_cast<unsigned>(nan_word);
  if (aligned(table, row_bytes, 16) && aligned(out, row_bytes, 16))
    return (int)launch<uint4>(table, id, out, n, vocab, row_bytes, w, s);
  if (aligned(table, row_bytes, 4) && aligned(out, row_bytes, 4))
    return (int)launch<uint32_t>(table, id, out, n, vocab, row_bytes, w, s);
  return (int)launch<uint8_t>(table, id, out, n, vocab, row_bytes, w, s);
}
