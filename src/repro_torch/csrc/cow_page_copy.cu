// Copy-on-write of pool pages, in place: for every job [src, dst, rem] and
// every leaf, rows [0, rem) of page dst take rows [0, rem) of page src and
// rows [rem, ps) take the leaf's fill value.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_maintenance.py
// (cow_page_copy / _cow_kernel): there each grid step DMAs one src page in
// and one dst page out, one pallas_call per leaf.
//
// Bound: bytes. Each job reads rem rows of one page and writes a whole page
// per leaf, at 3.35 TB/s on an H100: 8 KB a leaf page at glm4-9b (2 kv heads
// x 128 x bf16 x 16 rows), 128 KB at an MHA model such as pythia-6.9b (32 kv
// heads), about 11.7 MB for one copy over pythia's 31 stacked layers.
//
// Design: one flat grid over (job, leaf, access unit of the leaf's page), so
// every leaf of a layer stack goes in one launch and the work spreads over
// the whole card however many jobs there are. Leaves stacked over layers are
// passed flattened ((reps * NP, ps, ...)) with one job per layer, so a
// copy-on-write at admission costs one launch per cache whatever the depth.
// The unit is the widest access (16, 8, 4, 2 or 1 bytes) that the leaf's row
// width and base address allow, so a unit never straddles two rows and
// neighbouring threads touch neighbouring bytes of one page. Each thread
// reads its job's three words as 4-byte loads, decides its row's fate once
// (copy below rem, fill from rem on) and does one load and one store, or one
// store alone: fill rows issue no load, and src rows at or beyond rem are
// never read. Source loads go through the read-only path (__ldg): no job's
// dst is another job's src, so nothing the kernel writes is read by it.
// Elements of 4, 2 and 1 bytes take the same code: the fill is a bit pattern
// (-1 for the int32 position leaf, 0 otherwise). One unit a thread: 2 and 4
// were no faster at glm4-9b's or pythia-6.9b's pages on an H100 (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 6;
constexpr int kThreads = 128;

struct CowLeaf {
  char* pool;             // (n_pages, ps, row_bytes) contiguous
  long long n_pages;
  long long page_bytes;   // ps * row_bytes
  int unit;               // bytes per access
  int row_units;          // units per page row
  unsigned fill;          // the fill element's bytes, repeated to 32 bits
};

struct Params {
  CowLeaf l[kMaxLeaves];
  int end[kMaxLeaves];    // cumulative units of one job's pages, by leaf
  int n_leaves;
  int job_units;          // units of one job over every leaf
  int n_units;            // n_jobs * job_units
};

__device__ __forceinline__ uint4 load_unit(const char* src, int unit) {
  switch (unit) {
    case 16: return __ldg(reinterpret_cast<const uint4*>(src));
    case 8: {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      return make_uint4(v.x, v.y, 0, 0);
    }
    case 4: return make_uint4(__ldg(reinterpret_cast<const unsigned*>(src)), 0, 0, 0);
    case 2:
      return make_uint4(__ldg(reinterpret_cast<const unsigned short*>(src)), 0, 0, 0);
    default: return make_uint4(__ldg(reinterpret_cast<const unsigned char*>(src)), 0, 0, 0);
  }
}

__device__ __forceinline__ void store_unit(char* dst, int unit, uint4 v) {
  switch (unit) {
    case 16: *reinterpret_cast<uint4*>(dst) = v; break;
    case 8: *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<unsigned*>(dst) = v.x; break;
    case 2: *reinterpret_cast<unsigned short*>(dst) = (unsigned short)v.x; break;
    default: *reinterpret_cast<unsigned char*>(dst) = (unsigned char)v.x;
  }
}

// one thread a unit of the flat (job, leaf, page unit) sequence
__global__ void __launch_bounds__(kThreads)
cow_page_copy_kernel(const __grid_constant__ Params p, const int* __restrict__ sdr) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= p.n_units) return;
  const int job = g / p.job_units;
  int u = g - job * p.job_units, l = 0;
#pragma unroll
  for (int j = 0; j < kMaxLeaves - 1; ++j)
    if (j < p.n_leaves - 1 && u >= p.end[j]) l = j + 1;
  if (l > 0) u -= p.end[l - 1];
  const CowLeaf& L = p.l[l];
  const int* jb = sdr + 3LL * job;  // three 4-byte words
  const long long src = __ldg(jb), dst = __ldg(jb + 1);
  const int rem = __ldg(jb + 2);
  if (src < 0 || src >= L.n_pages || dst < 0 || dst >= L.n_pages) return;
  const long long off = (long long)u * L.unit;
  const uint4 v = u / L.row_units < rem
                      ? load_unit(L.pool + src * L.page_bytes + off, L.unit)
                      : make_uint4(L.fill, L.fill, L.fill, L.fill);
  store_unit(L.pool + dst * L.page_bytes + off, L.unit, v);
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
  Params p{};
  p.n_leaves = n_leaves;
  long long job_units = 0;
  for (int l = 0; l < n_leaves; ++l) {
    CowLeaf& L = p.l[l];
    if (row_bytes[l] <= 0) return (int)cudaErrorInvalidValue;
    L.pool = static_cast<char*>(pools[l]);
    L.n_pages = n_pages[l];
    L.unit = widest_unit(pools[l], row_bytes[l]);
    L.row_units = row_bytes[l] / L.unit;
    L.page_bytes = (long long)ps * row_bytes[l];
    L.fill = fills[l];
    job_units += (long long)ps * L.row_units;
    if (job_units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.end[l] = (int)job_units;
  }
  const long long units = (long long)n_jobs * job_units;
  if (units > 0x7fffffffLL - kThreads) return (int)cudaErrorInvalidValue;
  p.job_units = (int)job_units;
  p.n_units = (int)units;
  const long long blocks = (units + kThreads - 1) / kThreads;
  cow_page_copy_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(sdr));
  return (int)cudaGetLastError();
}
