// Copy-on-write of pool pages, in place: for every job [src, dst, rem] and
// every leaf, rows [0, rem) of page dst take rows [0, rem) of page src and
// rows [rem, ps) take the leaf's fill value.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_maintenance.py
// (cow_page_copy / _cow_kernel): there each grid step DMAs one src page in
// and one dst page out, one pallas_call per leaf.
//
// Bound: bytes. Each job reads rem rows of one page and writes a whole page
// per leaf, at 3.35 TB/s on an H100.
//
// Design: a grid of (job, leaf) blocks, so all the leaves of a layer stack
// go in one launch; leaves stacked over layers are passed flattened
// ((reps * NP, ps, ...)) with one job per layer, so a copy-on-write at
// admission costs one launch per cache whatever the depth. Each block
// streams one page with the widest access (16, 8, 4, 2 or 1 bytes) that the
// row width and base address allow; the src rows beyond rem are never
// read. Elements of 4, 2 and 1 bytes take the same code: the fill is a bit
// pattern (-1 for the int32 position leaf, 0 otherwise).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 6;
constexpr int kThreads = 128;

struct CowLeaf {
  char* pool;             // (n_pages, ps, row_bytes) contiguous
  long long n_pages;
  int row_bytes;
  int unit;
  unsigned fill;
};

struct CowLeaves {
  CowLeaf l[kMaxLeaves];
  int n;
};

template <typename U> __device__ __forceinline__ U pattern(unsigned f);
template <> __device__ __forceinline__ uint4 pattern<uint4>(unsigned f) {
  return make_uint4(f, f, f, f);
}
template <> __device__ __forceinline__ uint2 pattern<uint2>(unsigned f) {
  return make_uint2(f, f);
}
template <> __device__ __forceinline__ unsigned pattern<unsigned>(unsigned f) { return f; }
template <> __device__ __forceinline__ unsigned short pattern<unsigned short>(unsigned f) {
  return (unsigned short)f;
}
template <> __device__ __forceinline__ unsigned char pattern<unsigned char>(unsigned f) {
  return (unsigned char)f;
}

template <typename U>
__device__ void copy_page(const CowLeaf& L, long long src, long long dst, int rem, int ps) {
  const int units = L.row_bytes / (int)sizeof(U);
  const long long page_units = (long long)ps * units;
  const U* s = reinterpret_cast<const U*>(L.pool) + src * page_units;
  U* d = reinterpret_cast<U*>(L.pool) + dst * page_units;
  const U fillv = pattern<U>(L.fill);
  const long long keep = (long long)rem * units;
  for (long long i = threadIdx.x; i < page_units; i += blockDim.x)
    d[i] = i < keep ? s[i] : fillv;
}

__global__ void __launch_bounds__(kThreads)
cow_page_copy_kernel(CowLeaves leaves, const int* __restrict__ sdr, int ps) {
  const CowLeaf& L = leaves.l[blockIdx.y];
  const int* job = sdr + 3LL * blockIdx.x;
  const long long src = job[0], dst = job[1];
  int rem = job[2];
  if (src < 0 || src >= L.n_pages || dst < 0 || dst >= L.n_pages) return;
  rem = rem < 0 ? 0 : (rem > ps ? ps : rem);
  switch (L.unit) {
    case 16: copy_page<uint4>(L, src, dst, rem, ps); break;
    case 8: copy_page<uint2>(L, src, dst, rem, ps); break;
    case 4: copy_page<unsigned>(L, src, dst, rem, ps); break;
    case 2: copy_page<unsigned short>(L, src, dst, rem, ps); break;
    default: copy_page<unsigned char>(L, src, dst, rem, ps);
  }
}

int widest_unit(const void* pool, int row_bytes) {
  const int units[] = {16, 8, 4, 2};
  for (int u : units)
    if (row_bytes % u == 0 && reinterpret_cast<uintptr_t>(pool) % u == 0) return u;
  return 1;
}

}  // namespace

// pools: n_leaves device pointers; n_pages / row_bytes / fills per leaf
// (fills: the fill element's bytes repeated to 32 bits); sdr: (n_jobs, 3)
// int32 on the device, shared by every leaf.
extern "C" int cow_page_copy(void* const* pools, const long long* n_pages,
                             const int* row_bytes, const unsigned* fills, int n_leaves,
                             const void* sdr, int n_jobs, int ps, void* stream) {
  if (n_jobs <= 0 || n_leaves <= 0) return 0;
  if (n_leaves > kMaxLeaves || ps <= 0) return (int)cudaErrorInvalidValue;
  CowLeaves leaves{};
  leaves.n = n_leaves;
  for (int l = 0; l < n_leaves; ++l) {
    CowLeaf& L = leaves.l[l];
    L.pool = static_cast<char*>(pools[l]);
    L.n_pages = n_pages[l];
    L.row_bytes = row_bytes[l];
    L.fill = fills[l];
    L.unit = widest_unit(pools[l], row_bytes[l]);
  }
  const dim3 grid(n_jobs, n_leaves);
  cow_page_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, static_cast<const int*>(sdr), ps);
  return (int)cudaGetLastError();
}
