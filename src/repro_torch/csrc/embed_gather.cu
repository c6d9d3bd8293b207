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
// Design: one warp per row, four rows per 128-thread block. Each lane moves
// 16 bytes per access (uint4), so a warp moves 512 contiguous bytes per
// step and both the read and the write are fully coalesced; four loads are
// issued before the four stores to keep several requests in flight per
// lane. Rows whose byte width or base address is not a multiple of 16 fall
// back to 4-byte, then 1-byte, accesses (same structure). The copy is a bit
// copy, so the result equals table[ids] bitwise for every dtype. An id
// outside [0, vocab) yields a zero row rather than an out-of-bounds read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kUnroll = 4;

template <typename V>
__global__ void gather_rows(const V* __restrict__ table, const int* __restrict__ ids,
                            V* __restrict__ out, int n, int vocab, long long row_vecs) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= n) return;
  const int id = ids[row];
  V* dst = out + (long long)row * row_vecs;
  if (id < 0 || id >= vocab) {
    const V zero{};
    for (long long c = lane; c < row_vecs; c += 32) dst[c] = zero;
    return;
  }
  const V* src = table + (long long)id * row_vecs;
  long long c = lane;
  for (; c + 32 * (kUnroll - 1) < row_vecs; c += 32 * kUnroll) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) buf[u] = src[c + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[c + 32 * u] = buf[u];
  }
  for (; c < row_vecs; c += 32) dst[c] = src[c];
}

template <typename V>
cudaError_t launch(const void* table, const int* ids, void* out, int n, int vocab,
                   long long row_bytes, cudaStream_t stream) {
  const long long row_vecs = row_bytes / (long long)sizeof(V);
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_rows<V><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const V*>(table), ids, static_cast<V*>(out), n, vocab, row_vecs);
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
