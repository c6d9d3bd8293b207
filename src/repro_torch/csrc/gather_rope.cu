// Fused precomputed-row gather + layer-0 RoPE:
//   out[i, :] = table[ids[i], :] with every segment (offset, heads, hd)
//   half-split rotated for position pos[i].
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_rope.py
// (gather_rope / _gather_rope_kernel): the gathered row is rotated in the
// same pass, so it never round-trips through device memory between the
// gather and the rotation.
//
// Bound: bytes. Per token the kernel reads one row and writes one row
// (20 KB each in bf16 at the mistral-7b width); the trigonometry is hd/2
// sin/cos pairs per distinct head width, negligible beside the copy. At
// decode sizes (a few tokens) the launch and two dependent memory round
// trips (the id, then the row) dominate.
//
// Segments: GQA rows have two (q heads, k heads); MLA rows have one per head
// (its q_pe slice between the q_nope slices) plus the shared k_pe, 17 for
// deepseek-v2-lite-16b, so the segment table holds up to kMaxSegs = 32, and
// the head table up to kMaxHeads = 192 rotated heads over all segments
// (llama3-405b's 128 q + 8 k heads; up to 128 q + 64 k); the wrapper checks
// both before a launch. The plan (head columns and tiles) is passed by value
// as a __grid_constant__ and sized to stay inside the classic 4 KB of
// kernel parameters, which every CUDA 12 toolkit accepts.
//
// Design: grid (tokens, column tiles), so that even 4 tokens spread over
// the SMs. The host cuts a row once per call into tiles of about one unit
// per thread: a copy tile is a stretch of unrotated columns; a rotated
// tile is a run of whole heads of one width, addressed through a table of
// head offsets, so heads of different segments (q and k; deepseek's 17
// q_pe / k_pe slices) share tiles and nothing is looked up per column. A
// unit is VEC columns (VEC = 16 bytes: 8 bf16, 4 fp32) of a copy, or VEC
// pairs of a rotated head: the thread loads x1[j..j+VEC) of the first half
// and the matching x2 of the second half with two 16-byte loads, so every
// element is read once, and writes both rotated halves. Widths, offsets or
// addresses that do not allow 16-byte access take VEC = 1 in the same
// kernel. A rotated tile's block issues its first loads, then computes the
// hd/2 sin/cos pairs of its token once into shared memory (one set serves
// every head of the tile: q and k, or all 17 MLA slices), meets at a
// barrier and rotates. The arithmetic is the plain version's: angle =
// pos * inv[j] with the inverse frequencies supplied by the caller (the same
// fp32 vector the plain PyTorch version uses), accurate sinf/cosf (no
// fast-math intrinsics: positions reach tens of thousands of radians, where
// __sinf loses all accuracy), x1*cos - x2*sin and x1*sin + x2*cos in fp32,
// rounded to nearest in every operation (__fmul_rn/__fsub_rn/__fadd_rn keep
// the compiler from contracting to an FMA, matching the plain version's
// separate roundings), then converted once to the table dtype. Ids follow
// jnp.take, as the JAX table read does: an id in [-vocab, 0) reads row id +
// vocab; an id outside [-vocab, vocab) reads nothing and writes a row of NaN
// (the JAX Pallas kernel clamps such ids instead: a deliberate difference,
// ROADMAP C2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegs = 32;    // MLA rows: one per head's q_pe slice + k_pe
constexpr int kMaxHeads = 192;  // rotated heads over all segments
constexpr int kMaxTiles = 192;  // llama3-405b's row at 64 threads: 51

struct Tile {
  int hd;       // 0: a copy tile; else the head width of a rotated tile
  int first;    // copy: first column; rotated: first head (index into head_col)
  int units;    // copy: VEC-column units; rotated: heads * hd / 2 / VEC
  int inv_off;  // rotated: offset of this width's frequencies in inv
};

struct Plan {
  int n_tiles;
  int head_col[kMaxHeads];
  Tile t[kMaxTiles];
};
// the plan and the kernel's other arguments (5 pointers, 2 ints)
static_assert(sizeof(Plan) + 5 * sizeof(void*) + 2 * sizeof(int) <= 4096,
              "gather_rope's parameters exceed 4 KB");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// torch's NaN of each dtype (__float2bfloat16_rn would give 0x7FFF)
template <typename T> __device__ __forceinline__ T nan_of();
template <> __device__ __forceinline__ float nan_of<float>() { return __int_as_float(0x7FC00000); }
template <> __device__ __forceinline__ __nv_bfloat16 nan_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0x7FC0);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    union {
      uint4 raw;
      Pack<T, VEC> pack;
    } u;
    u.raw = __ldg(reinterpret_cast<const uint4*>(p));
    return u.pack;
  } else {
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) out.v[i] = p[i];
    return out;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& x) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = x;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> nan_pack() {
  Pack<T, VEC> out;
#pragma unroll
  for (int i = 0; i < VEC; ++i) out.v[i] = nan_of<T>();
  return out;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(128)
gather_rope_tiles(const T* __restrict__ table, const int* __restrict__ ids,
                  const int* __restrict__ pos, const float* __restrict__ inv,
                  T* __restrict__ out, int vocab, int width, const __grid_constant__ Plan plan) {
  extern __shared__ float trig[];  // sin[half] then cos[half]
  const int row = blockIdx.x;
  const Tile tile = plan.t[blockIdx.y];
  int id = __ldg(ids + row);
  const bool bad = id < -vocab || id >= vocab;  // jnp.take: a row of NaN
  if (id < 0) id += vocab;
  const T* src = table + (long long)id * width;
  T* dst = out + (long long)row * width;
  if (tile.hd == 0) {
    for (int u = threadIdx.x; u < tile.units; u += blockDim.x) {
      const int c = tile.first + u * VEC;
      store<T, VEC>(dst + c, bad ? nan_pack<T, VEC>() : load<T, VEC>(src + c));
    }
    return;
  }
  const int half = tile.hd / 2, upw = half / VEC;  // units per head
  if (bad) {  // the whole block: one token
    for (int u = threadIdx.x; u < tile.units; u += blockDim.x) {
      const int c = plan.head_col[tile.first + u / upw] + (u % upw) * VEC;
      store<T, VEC>(dst + c, nan_pack<T, VEC>());
      store<T, VEC>(dst + c + half, nan_pack<T, VEC>());
    }
    return;
  }
  // the first unit's loads go out before the trigonometry
  int u = threadIdx.x;
  int c = 0;
  Pack<T, VEC> x1, x2;
  if (u < tile.units) {
    c = plan.head_col[tile.first + u / upw] + (u % upw) * VEC;
    x1 = load<T, VEC>(src + c);
    x2 = load<T, VEC>(src + c + half);
  }
  const float p = (float)__ldg(pos + row);
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const float ang = __fmul_rn(p, __ldg(inv + tile.inv_off + j));
    trig[j] = sinf(ang);
    trig[half + j] = cosf(ang);
  }
  __syncthreads();
  while (u < tile.units) {
    const int j0 = (u % upw) * VEC;
    Pack<T, VEC> y1, y2;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float a = to_f(x1.v[i]), b = to_f(x2.v[i]);
      const float sn = trig[j0 + i], cs = trig[half + j0 + i];
      y1.v[i] = from_f<T>(__fsub_rn(__fmul_rn(a, cs), __fmul_rn(b, sn)));
      y2.v[i] = from_f<T>(__fadd_rn(__fmul_rn(a, sn), __fmul_rn(b, cs)));
    }
    store<T, VEC>(dst + c, y1);
    store<T, VEC>(dst + c + half, y2);
    u += blockDim.x;
    if (u < tile.units) {
      c = plan.head_col[tile.first + u / upw] + (u % upw) * VEC;
      x1 = load<T, VEC>(src + c);
      x2 = load<T, VEC>(src + c + half);
    }
  }
}

// Cuts a row into tiles of at most `target` units; false if the plan's
// tables overflow.
bool make_plan(Plan& plan, int& max_half, const int* off, const int* heads, const int* hd,
               const int* inv_off, int n_segs, int width, int vec, int target) {
  plan.n_tiles = 0;
  max_half = 0;
  auto add = [&](int h, int first, int units, int io) {
    if (plan.n_tiles == kMaxTiles) return false;
    plan.t[plan.n_tiles++] = Tile{h, first, units, io};
    return true;
  };
  auto copy = [&](int c0, int c1) {
    for (int c = c0; c < c1; c += target * vec) {
      const int n = (c1 - c < target * vec ? c1 - c : target * vec) / vec;
      if (!add(0, c, n, 0)) return false;
    }
    return true;
  };
  int head_hd[kMaxHeads], head_io[kMaxHeads];
  int n_heads = 0, cur = 0;
  for (int s = 0; s < n_segs; ++s) {
    if (!copy(cur, off[s])) return false;
    for (int h = 0; h < heads[s]; ++h) {
      if (n_heads == kMaxHeads) return false;
      head_hd[n_heads] = hd[s];
      head_io[n_heads] = inv_off[s];
      plan.head_col[n_heads++] = off[s] + h * hd[s];
    }
    cur = off[s] + heads[s] * hd[s];
    if (hd[s] / 2 > max_half) max_half = hd[s] / 2;
  }
  if (!copy(cur, width)) return false;
  // rotated tiles: runs of whole heads of one width, across segments
  for (int h = 0; h < n_heads;) {
    const int w = head_hd[h], upw = w / 2 / vec;
    const int per = target / upw > 0 ? target / upw : 1;
    int n = 1;
    while (h + n < n_heads && n < per && head_hd[h + n] == w) ++n;
    if (!add(w, h, n * upw, head_io[h])) return false;
    h += n;
  }
  return true;
}

template <typename T, int VEC>
int launch(const void* table, const int* ids, const int* pos, const float* inv, void* out,
           int n, int vocab, int width, const Plan& plan, int threads, int max_half,
           cudaStream_t st) {
  const dim3 grid(n, plan.n_tiles);
  const size_t smem = sizeof(float) * 2 * (max_half > 0 ? max_half : 1);
  gather_rope_tiles<T, VEC><<<grid, threads, smem, st>>>(
      static_cast<const T*>(table), ids, pos, inv, static_cast<T*>(out), vocab, width, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Threads a block: 64 up to 128
// tokens, then 128, the fastest of 32, 64 and 128 on an H100 at N 1-512 for
// the three row layouts (scripts/gather_rope_sweep.py, which builds this
// file with GATHER_ROPE_THREADS defined to each of them).
extern "C" int gather_rope(const void* table, const void* ids, const void* pos,
                           const void* inv, void* out, int n, int vocab, int width,
                           int dtype_code, const void* seg_off, const void* seg_heads,
                           const void* seg_hd, const void* seg_inv_off, int n_segs,
                           void* stream) {
  if (n <= 0) return 0;
  if (n_segs < 0 || n_segs > kMaxSegs || (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(seg_off);
  const int* heads = static_cast<const int*>(seg_heads);
  const int* hd = static_cast<const int*>(seg_hd);
  const int* io = static_cast<const int*>(seg_inv_off);
  const int es = dtype_code == 0 ? 4 : 2, wide = 16 / es;
  bool ok = width % wide == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int s = 0; s < n_segs; ++s) ok = ok && off[s] % wide == 0 && (hd[s] / 2) % wide == 0;
  const int vec = ok ? wide : 1;
#ifdef GATHER_ROPE_THREADS
  const int threads = GATHER_ROPE_THREADS;
#else
  const int threads = n <= 128 ? 64 : 128;
#endif
  Plan plan;
  int max_half = 0, target = threads;
  while (!make_plan(plan, max_half, off, heads, hd, io, n_segs, width, vec, target)) {
    if (target >= (1 << 20)) return (int)cudaErrorInvalidValue;
    target *= 2;
  }
  if (max_half * 2 * (int)sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const int* ps = static_cast<const int*>(pos);
  const float* iv = static_cast<const float*>(inv);
  if (dtype_code == 0)
    return vec == 4 ? launch<float, 4>(table, id, ps, iv, out, n, vocab, width, plan, threads,
                                       max_half, st)
                    : launch<float, 1>(table, id, ps, iv, out, n, vocab, width, plan, threads,
                                       max_half, st);
  return vec == 8 ? launch<__nv_bfloat16, 8>(table, id, ps, iv, out, n, vocab, width, plan,
                                             threads, max_half, st)
                  : launch<__nv_bfloat16, 1>(table, id, ps, iv, out, n, vocab, width, plan,
                                             threads, max_half, st);
}
