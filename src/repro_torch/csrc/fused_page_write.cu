// Chunk K/V scatter into pool pages with deferred clear-on-alloc, in place:
// for every job [page, slot, delta, nv, mode, vbase] and every leaf, row r of
// the page takes chunk lane t = (delta + r) mod Sc of slot `slot` when
// t < nv and vbase + r < Sc; otherwise, for mode >= 1 (a fresh page, or a
// whole-page clear), it takes the leaf's fill value; otherwise it is left
// alone.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_maintenance.py
// (fused_page_write / _scatter_kernel). There each grid step DMAs one whole
// page in, gathers the chunk rows into it with a one-hot matmul (the TPU's
// way to an exact gather) and writes the whole page back; one pallas_call
// runs per leaf.
//
// Bound: bytes. Nothing is computed; the least traffic is the rows that
// change (chunk rows read once and written once, fill rows written once)
// plus the job list, at 3.35 TB/s on an H100.
//
// Design: one block per job, which reads its six job words and stores only
// the rows that change, straight from the chunk values to the pool: no page
// is read, no unchanged row is written back. That also makes concurrent
// blocks safe without ordering: two jobs name the same page only where
// both write identical bytes (the null page 0, which holds the fill value,
// or a clear demoted onto it), so the Pallas kernel's write-hazard rule
// holds by construction. All leaves of one layer's cache (k, v and the
// int32 position leaf) go in the same launch; a leaf is described by its
// pool pointer, the byte strides of its (slot, lane) chunk rows, its row
// width in bytes and its fill value's bytes, so elements of 4, 2 and 1
// bytes (fp32 / bf16 / int8 K/V, bf16 scales, int32 positions) take the
// same code. Each leaf is moved in the widest access (16, 8, 4, 2 or 1
// bytes) that its row width, base addresses and strides allow: 16 bytes per
// thread for the 512-byte K/V rows of glm4-9b, 4 for the position leaf and
// for its int8 cache's 4-byte scale rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 6;
constexpr int kThreads = 128;

struct Leaf {
  char* pool;             // (NP, ps, row_bytes) contiguous
  const char* vals;       // row (b, t) at vals + b * stride_b + t * stride_t
  long long stride_b, stride_t;
  int row_bytes;
  int unit;               // bytes per access
  unsigned fill;          // the fill element's bytes, repeated to 32 bits
};

struct Leaves {
  Leaf l[kMaxLeaves];
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
__device__ void write_leaf(const Leaf& L, long long page, int slot, int delta, int nv,
                           int mode, int vbase, int ps, int Sc) {
  const int units = L.row_bytes / (int)sizeof(U);
  U* dst = reinterpret_cast<U*>(L.pool + page * ps * (long long)L.row_bytes);
  const U fillv = pattern<U>(L.fill);
  for (int i = threadIdx.x; i < ps * units; i += blockDim.x) {
    const int r = i / units, c = i - r * units;
    int t = delta + r;
    if (t >= Sc) t -= Sc;
    if (t < nv && vbase + r < Sc) {
      const U* src = reinterpret_cast<const U*>(L.vals + slot * L.stride_b + t * L.stride_t);
      dst[(long long)r * units + c] = src[c];
    } else if (mode >= 1) {
      dst[(long long)r * units + c] = fillv;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_page_write_kernel(Leaves leaves, const int* __restrict__ jobs, int NP, int B, int ps,
                        int Sc) {
  const int* jb = jobs + 6LL * blockIdx.x;
  const int page = jb[0], slot = jb[1], delta = jb[2], nv = jb[3], mode = jb[4],
            vbase = jb[5];
  if (page < 0 || page >= NP) return;
  if (nv > 0 && (slot < 0 || slot >= B)) return;
  for (int l = 0; l < leaves.n; ++l) {
    const Leaf& L = leaves.l[l];
    switch (L.unit) {
      case 16: write_leaf<uint4>(L, page, slot, delta, nv, mode, vbase, ps, Sc); break;
      case 8: write_leaf<uint2>(L, page, slot, delta, nv, mode, vbase, ps, Sc); break;
      case 4: write_leaf<unsigned>(L, page, slot, delta, nv, mode, vbase, ps, Sc); break;
      case 2: write_leaf<unsigned short>(L, page, slot, delta, nv, mode, vbase, ps, Sc); break;
      default: write_leaf<unsigned char>(L, page, slot, delta, nv, mode, vbase, ps, Sc);
    }
  }
}

int widest_unit(const void* pool, const void* vals, long long sb, long long st, int row_bytes) {
  const int units[] = {16, 8, 4, 2};
  for (int u : units) {
    if (row_bytes % u == 0 && reinterpret_cast<uintptr_t>(pool) % u == 0 &&
        reinterpret_cast<uintptr_t>(vals) % u == 0 && sb % u == 0 && st % u == 0)
      return u;
  }
  return 1;
}

}  // namespace

// pools / vals: n_leaves device pointers; strides: (stride_b, stride_t) bytes
// per leaf; row_bytes: bytes of one page row per leaf; fills: fill bytes
// repeated to 32 bits per leaf; jobs: (n_jobs, 6) int32 on the device.
extern "C" int fused_page_write(void* const* pools, const void* const* vals,
                                const long long* strides, const int* row_bytes,
                                const unsigned* fills, int n_leaves, const void* jobs,
                                int n_jobs, int NP, int B, int ps, int Sc, void* stream) {
  if (n_jobs <= 0 || n_leaves <= 0) return 0;
  if (n_leaves > kMaxLeaves || ps <= 0 || Sc <= 0) return (int)cudaErrorInvalidValue;
  Leaves leaves{};
  leaves.n = n_leaves;
  for (int l = 0; l < n_leaves; ++l) {
    Leaf& L = leaves.l[l];
    L.pool = static_cast<char*>(pools[l]);
    L.vals = static_cast<const char*>(vals[l]);
    L.stride_b = strides[2 * l];
    L.stride_t = strides[2 * l + 1];
    L.row_bytes = row_bytes[l];
    L.fill = fills[l];
    L.unit = widest_unit(pools[l], vals[l], L.stride_b, L.stride_t, L.row_bytes);
  }
  fused_page_write_kernel<<<n_jobs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, static_cast<const int*>(jobs), NP, B, ps, Sc);
  return (int)cudaGetLastError();
}
