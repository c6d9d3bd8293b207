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
// dtype. An id outside [0, vocab) yields a zero row rather than an
// out-of-bounds read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;
constexpr long long kChunk = kThreads * kUnroll;  // vectors of a block

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows(const V* __restrict__ table, const int* __restrict__ ids, V* __restrict__ out,
            int vocab, long long row_vecs) {
  const long long row = blockIdx.x;
  const long long c0 = blockIdx.y * kChunk + threadIdx.x;
  const int id = ids[row];
  V* dst = out + row * row_vecs;
  if (id < 0 || id >= vocab) {
    const V zero{};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c0 + u * kThreads < row_vecs) dst[c0 + u * kThreads] = zero;
    return;
  }
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
                   long long row_bytes, cudaStream_t stream) {
  const long long row_vecs = row_bytes / (long long)sizeof(V);
  const long long chunks = (row_vecs + kChunk - 1) / kChunk;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  if (chunks == 0) return cudaSuccess;
  gather_rows<V><<<dim3(n, (unsigned)chunks), kThreads, 0, stream>>>(
      static_cast<const V*>(table), ids, static_cast<V*>(out), vocab, row_vecs);
  return cudaGetLastError();
}

bool aligned(const void* p, long long bytes, int to) {
  return (reinterpret_cast<uintptr_t>(p) % to) == 0 && bytes % to == 0;
}

}  // namespace

extern "C" int embed_gather(const void* table, const void* ids, void* out, int n,
                            int vocab, long long row_bytes, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (aligned(table, row_bytes, 16) && aligned(out, row_bytes, 16))
    return (int)launch<uint4>(table, id, out, n, vocab, row_bytes, s);
  if (aligned(table, row_bytes, 4) && aligned(out, row_bytes, 4))
    return (int)launch<uint32_t>(table, id, out, n, vocab, row_bytes, s);
  return (int)launch<uint8_t>(table, id, out, n, vocab, row_bytes, s);
}
