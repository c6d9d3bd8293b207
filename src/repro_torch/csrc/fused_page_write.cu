// Chunk K/V scatter into pool pages with deferred clear-on-alloc, in place:
// for every job [page, slot, delta, nv, mode, vbase] and every leaf, row r of
// the page takes chunk lane t = (delta + r) mod Sc of slot `slot` when
// t < nv and vbase + r < Sc; otherwise, for mode >= 1 (a fresh page, or a
// whole-page clear), it takes the leaf's fill value; otherwise it is left
// alone. The quantizing form also makes the int8 K/V rows and their bf16
// scales from float chunk values inside the same launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_maintenance.py
// (fused_page_write / _scatter_kernel). There each grid step DMAs one whole
// page in, gathers the chunk rows into it with a one-hot matmul (the TPU's
// way to an exact gather) and writes the whole page back; one pallas_call
// runs per leaf, and XLA fuses the int8 quantizer (models/attention.py
// _quantize) into the ops that feed it.
//
// Bound: bytes. Nothing but the quantizer is computed; the least traffic is
// the rows that change (chunk rows read once and written once, fill rows
// written once) plus the job list, at 3.35 TB/s on an H100. At the engine's
// decode sizes (a few written rows) the launch itself dominates.
//
// Design: every (job, page row) pair is decided once from the job's six
// words: written (lane t), filled, or left alone; rows left alone cost no
// load. The work of a row is spread over threads so that each thread does
// one load and one store and nothing waits on another thread's store:
//  - plain leaves (bf16 / fp32 K/V, MLA latents, int32 positions, int8
//    values already quantized): one thread per access unit of a row, the
//    widest (16, 8, 4, 2 or 1 bytes) that the leaf's row width, base
//    addresses and strides allow: 32 threads of 16 bytes per 512-byte glm4-9b
//    K or V row, one of 4 bytes for its position row. The units of all
//    leaves of a row are numbered in one sequence, so a launch is one flat
//    grid over (job, row, unit);
//  - a quantized leaf (int8 values + bf16 scale leaf, float chunk values):
//    one warp per (job, row, leaf, head pass). A head's values are read in
//    16-byte chunks spread over L lanes (L = 16 for bf16 hd 128), the amax
//    is a shuffle reduction over those lanes, and each lane stores its
//    chunk's int8 values (8 bytes for bf16 hd 128) and the head's first lane
//    its scale. Arithmetic as torch's CUDA kernels do it for
//    models/attention.py _quantize (no fast math): amax of |x| in fp32 with
//    NaN propagated, scale = max(amax * fl(1/127), 1e-8) (torch multiplies by
//    the reciprocal when it divides a CUDA tensor by a Python scalar), q =
//    rint(x / scale) with an IEEE division, clamped to [-127, 127], NaN -> 0,
//    the scale rounded to bf16 (cvt.rn, NaN -> 0x7FFF).
// Chunk values are read through the non-coherent path (__ldg): the kernel
// never writes them. Concurrent threads need no ordering: two jobs name the
// same page only where both write identical bytes (the null page 0, which
// holds the fill value, or a clear demoted onto it), so the Pallas kernel's
// write-hazard rule holds by construction. All leaves of one layer's cache
// (k, v, the int8 cache's k_scale / v_scale, the position leaf; MLA's ckv,
// kpe, pos) go in the same launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 6;
constexpr int kMaxQuant = 2;
constexpr int kMaxCpl = 4;      // chunks per lane of one quantized head
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Leaf {
  char* pool;             // (NP, ps, row_bytes) contiguous
  const char* vals;       // row (b, t) at vals + b * stride_b + t * stride_t
  long long stride_b, stride_t;
  int row_bytes;
  int unit;               // bytes per access
  unsigned fill;          // the fill element's bytes, repeated to 32 bits
};

struct Quant {
  int q_leaf, s_leaf;     // the int8 value leaf and its bf16 scale leaf
  const char* src;        // float row (b, t): heads x hd, contiguous
  long long stride_b, stride_t;
  int heads, hd;
  int vec;                // elements per chunk: 16 bytes, or 1
  int lanes;              // lanes per head (a power of two <= 32)
  int cpl;                // chunks per lane
  int passes;             // warps per row: ceil(heads / (32 / lanes))
  int bf16;               // source dtype: 1 bf16, 0 fp32
};

struct Params {
  Leaf l[kMaxLeaves];
  int n_leaves;
  int plain[kMaxLeaves];       // leaves written unit by unit
  int plain_end[kMaxLeaves];   // cumulative units per row
  int n_plain, row_units;
  Quant q[kMaxQuant];
  int n_quant, row_warps;      // quantized: warps per row
  int q_blocks;                // blocks of the quantized part of the grid
  int NP, B, ps, Sc, n_rows;   // n_rows = n_jobs * ps
};

// -------------------------------------------------------------- row fates
enum Fate { kSkip = 0, kWrite = 1, kFill = 2 };

struct Row {
  long long dst_row;      // page * ps + r
  long long src_b;        // slot
  int t;
  int fate;
};

__device__ __forceinline__ Row row_fate(const int* __restrict__ jobs, int row,
                                        const Params& p) {
  const int job = row / p.ps, r = row - job * p.ps;
  const int* jb = jobs + 6LL * job;  // 4-byte aligned: a view of a staged buffer
  const int page = __ldg(jb), slot = __ldg(jb + 1), delta = __ldg(jb + 2), nv = __ldg(jb + 3),
            mode = __ldg(jb + 4), vbase = __ldg(jb + 5);
  Row out{0, 0, 0, kSkip};
  if (page < 0 || page >= p.NP) return out;
  if (nv > 0 && (slot < 0 || slot >= p.B)) return out;
  int t = delta + r;
  if (t >= p.Sc) t -= p.Sc;
  out.dst_row = (long long)page * p.ps + r;
  out.src_b = slot;
  out.t = t;
  if (t < nv && vbase + r < p.Sc) out.fate = kWrite;
  else if (mode >= 1) out.fate = kFill;
  return out;
}

// ---------------------------------------------------------- plain leaves
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

// unit g of the flat (job, row, unit) sequence of the plain leaves
__device__ void plain_unit(const Params& p, const int* __restrict__ jobs, int g) {
  const int row = g / p.row_units;
  if (row >= p.n_rows) return;
  int u = g - row * p.row_units, l = 0;
#pragma unroll
  for (int j = 0; j < kMaxLeaves - 1; ++j)
    if (j < p.n_plain - 1 && u >= p.plain_end[j]) l = j + 1;
  if (l > 0) u -= p.plain_end[l - 1];
  const Leaf& L = p.l[p.plain[l]];
  const Row f = row_fate(jobs, row, p);
  if (f.fate == kSkip) return;
  const int off = u * L.unit;
  const uint4 v = f.fate == kWrite
                      ? load_unit(L.vals + f.src_b * L.stride_b + f.t * L.stride_t + off, L.unit)
                      : make_uint4(L.fill, L.fill, L.fill, L.fill);
  store_unit(L.pool + f.dst_row * L.row_bytes + off, L.unit, v);
}

// ------------------------------------------------------- quantized leaves
template <typename S> __device__ __forceinline__ float to_f(S x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// torch: (x / scale).round().clamp(-127, 127).to(int8); NaN stays NaN
// through round and clamp and converts to 0
__device__ __forceinline__ int quant1(float x, float scale) {
  const float y = rintf(__fdiv_rn(x, scale));
  if (y != y) return 0;
  return (int)fminf(fmaxf(y, -127.0f), 127.0f);
}

template <typename S, int VEC>
__device__ void quant_warp(const Params& p, const int* __restrict__ jobs, int w) {
  const int row = w / p.row_warps;
  if (row >= p.n_rows) return;
  int qi = w - row * p.row_warps, k = 0;
  if (p.n_quant > 1 && qi >= p.q[0].passes) {
    qi -= p.q[0].passes;
    k = 1;
  }
  const Quant& Q = p.q[k];
  const Leaf& LQ = p.l[Q.q_leaf];
  const Leaf& LS = p.l[Q.s_leaf];
  const Row f = row_fate(jobs, row, p);
  if (f.fate == kSkip) return;  // the whole warp: one row
  const int lane = threadIdx.x & 31;
  const int h = qi * (32 / Q.lanes) + lane / Q.lanes;
  const int jl = lane % Q.lanes;
  const int chunks = Q.hd / VEC;
  const bool head_ok = h < Q.heads;
  char* qrow = LQ.pool + f.dst_row * LQ.row_bytes + (long long)h * Q.hd;
  char* srow = LS.pool + f.dst_row * LS.row_bytes + 2LL * h;
  if (f.fate == kFill) {
    if (!head_ok) return;
    for (int c = 0; c < Q.cpl; ++c) {
      const int j = jl + Q.lanes * c;
      if (j >= chunks) break;
      for (int e = 0; e < VEC; ++e) qrow[j * VEC + e] = (char)LQ.fill;
    }
    if (jl == 0) *reinterpret_cast<unsigned short*>(srow) = (unsigned short)LS.fill;
    return;
  }
  const S* src = reinterpret_cast<const S*>(Q.src + f.src_b * Q.stride_b +
                                            f.t * Q.stride_t) + (long long)h * Q.hd;
  float x[kMaxCpl][VEC];
  // every lane takes part in the shuffles; lanes past the heads hold zeros
#pragma unroll
  for (int c = 0; c < kMaxCpl; ++c) {
    const int j = jl + Q.lanes * c;
    const bool ok = head_ok && c < Q.cpl && j < chunks;
    if constexpr (VEC * sizeof(S) == 16) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (ok) raw = __ldg(reinterpret_cast<const uint4*>(src + j * VEC));
      const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[c][i] = to_f(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[c][i] = ok ? to_f(src[j * VEC + i]) : 0.0f;
    }
  }
  float amax = 0.0f;
  bool nan = false;
#pragma unroll
  for (int c = 0; c < kMaxCpl; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float a = fabsf(x[c][i]);
      nan |= a != a;
      amax = fmaxf(amax, a);
    }
  for (int m = Q.lanes >> 1; m > 0; m >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
    nan |= __shfl_xor_sync(0xffffffffu, (int)nan, m) != 0;
  }
  if (!head_ok) return;
  if (nan) amax = __int_as_float(0x7FC00000);
  float scale = __fmul_rn(amax, 1.0f / 127.0f);
  if (!(scale != scale)) scale = fmaxf(scale, (float)1e-8);
#pragma unroll
  for (int c = 0; c < kMaxCpl; ++c) {
    const int j = jl + Q.lanes * c;
    if (c >= Q.cpl || j >= chunks) break;
    if constexpr (VEC == 8) {
      unsigned lo = 0, hi = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo |= (unsigned)(quant1(x[c][i], scale) & 0xff) << (8 * i);
        hi |= (unsigned)(quant1(x[c][i + 4], scale) & 0xff) << (8 * i);
      }
      *reinterpret_cast<uint2*>(qrow + j * VEC) = make_uint2(lo, hi);
    } else if constexpr (VEC == 4) {
      unsigned v = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) v |= (unsigned)(quant1(x[c][i], scale) & 0xff) << (8 * i);
      *reinterpret_cast<unsigned*>(qrow + j * VEC) = v;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qrow[j * VEC + i] = (char)quant1(x[c][i], scale);
    }
  }
  if (jl == 0)
    *reinterpret_cast<__nv_bfloat16*>(srow) = __float2bfloat16_rn(scale);
}

// grid: p.q_blocks blocks of quantized warps, then the plain units
__global__ void __launch_bounds__(kThreads)
fused_page_write_kernel(const __grid_constant__ Params p, const int* __restrict__ jobs) {
  if ((int)blockIdx.x < p.q_blocks) {
    const int w = blockIdx.x * kWarps + threadIdx.x / 32;
    const Quant& Q = p.q[0];   // every quantized leaf of a launch: one type
    if (Q.bf16) {
      if (Q.vec == 8) quant_warp<__nv_bfloat16, 8>(p, jobs, w);
      else quant_warp<__nv_bfloat16, 1>(p, jobs, w);
    } else {
      if (Q.vec == 4) quant_warp<float, 4>(p, jobs, w);
      else quant_warp<float, 1>(p, jobs, w);
    }
    return;
  }
  plain_unit(p, jobs, (blockIdx.x - p.q_blocks) * kThreads + threadIdx.x);
}

bool aligned(const void* ptr, long long a, long long b, int u) {
  return reinterpret_cast<uintptr_t>(ptr) % u == 0 && a % u == 0 && b % u == 0;
}

int widest_unit(const void* pool, const void* vals, long long sb, long long st, int row_bytes) {
  const int units[] = {16, 8, 4, 2};
  for (int u : units)
    if (row_bytes % u == 0 && aligned(pool, 0, 0, u) && aligned(vals, sb, st, u)) return u;
  return 1;
}

}  // namespace

// pools / vals: n_leaves device pointers; strides: (stride_b, stride_t) bytes
// per leaf; row_bytes: bytes of one page row per leaf; fills: fill bytes
// repeated to 32 bits per leaf; jobs: (n_jobs, 6) int32 on the device.
// quant: n_quant records of 4 ints (value leaf, scale leaf, hd, source dtype:
// 1 bf16, 0 fp32); the value leaf's vals / strides then describe the float
// source rows (heads x hd elements), and the scale leaf's vals are unused.
extern "C" int fused_page_write(void* const* pools, const void* const* vals,
                                const long long* strides, const int* row_bytes,
                                const unsigned* fills, int n_leaves, const int* quant,
                                int n_quant, const void* jobs, int n_jobs, int NP, int B,
                                int ps, int Sc, void* stream) {
  if (n_jobs <= 0 || n_leaves <= 0) return 0;
  if (n_leaves > kMaxLeaves || n_quant < 0 || n_quant > kMaxQuant || ps <= 0 || Sc <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.n_leaves = n_leaves;
  p.NP = NP;
  p.B = B;
  p.ps = ps;
  p.Sc = Sc;
  p.n_rows = n_jobs * ps;
  bool quantized[kMaxLeaves] = {};
  for (int l = 0; l < n_leaves; ++l) {
    Leaf& L = p.l[l];
    L.pool = static_cast<char*>(pools[l]);
    L.vals = static_cast<const char*>(vals[l]);
    L.stride_b = strides[2 * l];
    L.stride_t = strides[2 * l + 1];
    L.row_bytes = row_bytes[l];
    L.fill = fills[l];
  }
  p.n_quant = n_quant;
  for (int k = 0; k < n_quant; ++k) {
    Quant& Q = p.q[k];
    Q.q_leaf = quant[4 * k];
    Q.s_leaf = quant[4 * k + 1];
    Q.hd = quant[4 * k + 2];
    Q.bf16 = quant[4 * k + 3];
    if (Q.q_leaf < 0 || Q.q_leaf >= n_leaves || Q.s_leaf < 0 || Q.s_leaf >= n_leaves ||
        Q.hd <= 0 || p.l[Q.q_leaf].row_bytes % Q.hd || Q.bf16 != p.q[0].bf16)
      return (int)cudaErrorInvalidValue;
    quantized[Q.q_leaf] = quantized[Q.s_leaf] = true;
    const Leaf& L = p.l[Q.q_leaf];
    Q.src = L.vals;
    Q.stride_b = L.stride_b;
    Q.stride_t = L.stride_t;
    Q.heads = L.row_bytes / Q.hd;
    if (p.l[Q.s_leaf].row_bytes != 2 * Q.heads) return (int)cudaErrorInvalidValue;
    const int wide = Q.bf16 ? 8 : 4;                 // 16 bytes
    Q.vec = Q.hd % wide == 0 && aligned(Q.src, Q.stride_b, Q.stride_t, 16) &&
                    aligned(L.pool, 0, 0, wide)
                ? wide
                : 1;
  }
  if (n_quant == 2 && p.q[0].vec != p.q[1].vec)  // one instantiation a launch
    p.q[0].vec = p.q[1].vec = 1;
  for (int k = 0; k < n_quant; ++k) {
    Quant& Q = p.q[k];
    const int chunks = Q.hd / Q.vec;
    Q.lanes = 1;
    while (Q.lanes < chunks && Q.lanes < 32) Q.lanes *= 2;
    Q.cpl = (chunks + Q.lanes - 1) / Q.lanes;
    if (Q.cpl > kMaxCpl) return (int)cudaErrorInvalidValue;
    Q.passes = (Q.heads + 32 / Q.lanes - 1) / (32 / Q.lanes);
    p.row_warps += Q.passes;
  }
  for (int l = 0; l < n_leaves; ++l) {
    if (quantized[l]) continue;
    Leaf& L = p.l[l];
    L.unit = widest_unit(L.pool, L.vals, L.stride_b, L.stride_t, L.row_bytes);
    p.plain[p.n_plain] = l;
    p.row_units += L.row_bytes / L.unit;
    p.plain_end[p.n_plain++] = p.row_units;
  }
  const long long q_warps = (long long)p.n_rows * p.row_warps;
  const long long units = (long long)p.n_rows * p.row_units;
  p.q_blocks = (int)((q_warps + kWarps - 1) / kWarps);
  const long long blocks = p.q_blocks + (units + kThreads - 1) / kThreads;
  if (blocks <= 0) return 0;
  if (blocks * kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_page_write_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(jobs));
  return (int)cudaGetLastError();
}
