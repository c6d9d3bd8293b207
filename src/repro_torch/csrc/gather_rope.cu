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
// (20 KB each in bf16 at the mistral-7b width); the trigonometry is
// sum(hd/2) sin/cos pairs per token, negligible beside the copy.
//
// Design: one block per token. The block first computes the segment angles
// once into shared memory: angle = pos * inv[j] with the inverse frequencies
// supplied by the caller (the same fp32 vector the plain PyTorch version
// uses, so both rotate by bitwise equal angles), then accurate sinf/cosf
// (no fast-math intrinsics: positions reach tens of thousands of radians,
// where __sinf loses all accuracy). Threads then walk the row's columns with
// coalesced accesses: columns outside the segments are bit copies; a column
// inside a segment reads its rotation partner from the same (L1-resident)
// row and writes x1*cos - x2*sin or x1*sin + x2*cos in fp32, rounded to
// nearest in every operation (__fmul_rn/__fsub_rn keep the compiler from
// contracting to an FMA, matching the plain version's separate roundings),
// then converted once to the table dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSegs = 4;
constexpr int kThreads = 256;

struct Segs {
  int n;
  int off[kMaxSegs];
  int heads[kMaxSegs];
  int hd[kMaxSegs];
  int inv_off[kMaxSegs];
  int trig_off[kMaxSegs];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void gather_rope_rows(const T* __restrict__ table, const int* __restrict__ ids,
                                 const int* __restrict__ pos, const float* __restrict__ inv,
                                 T* __restrict__ out, int vocab, int width, Segs segs) {
  extern __shared__ float trig[];  // per segment: sin[hd/2] then cos[hd/2]
  const int row = blockIdx.x;
  const int id = ids[row];
  T* dst = out + (long long)row * width;
  if (id < 0 || id >= vocab) {
    for (int c = threadIdx.x; c < width; c += blockDim.x) dst[c] = from_f<T>(0.f);
    return;
  }
  const float p = (float)pos[row];
  for (int s = 0; s < segs.n; ++s) {
    const int half = segs.hd[s] / 2;
    float* sn = trig + segs.trig_off[s];
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const float ang = __fmul_rn(p, inv[segs.inv_off[s] + j]);
      sn[j] = sinf(ang);
      sn[half + j] = cosf(ang);
    }
  }
  __syncthreads();
  const T* src = table + (long long)id * width;
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    int s = 0;
    for (; s < segs.n; ++s)
      if (c >= segs.off[s] && c < segs.off[s] + segs.heads[s] * segs.hd[s]) break;
    if (s == segs.n) {
      dst[c] = src[c];
      continue;
    }
    const int hd = segs.hd[s], half = hd / 2;
    const int local = c - segs.off[s];
    const int base = segs.off[s] + (local / hd) * hd;
    const int j = local % hd;
    const float* sn = trig + segs.trig_off[s];
    float y;
    if (j < half) {
      const float x1 = to_f(src[base + j]), x2 = to_f(src[base + j + half]);
      y = __fsub_rn(__fmul_rn(x1, sn[half + j]), __fmul_rn(x2, sn[j]));
    } else {
      const int k = j - half;
      const float x1 = to_f(src[base + k]), x2 = to_f(src[base + j]);
      y = __fadd_rn(__fmul_rn(x1, sn[k]), __fmul_rn(x2, sn[half + k]));
    }
    dst[c] = from_f<T>(y);
  }
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16.
extern "C" int gather_rope(const void* table, const void* ids, const void* pos,
                           const void* inv, void* out, int n, int vocab, int width,
                           int dtype_code, const void* seg_off, const void* seg_heads,
                           const void* seg_hd, const void* seg_inv_off, int n_segs,
                           void* stream) {
  if (n <= 0) return 0;
  if (n_segs < 0 || n_segs > kMaxSegs) return (int)cudaErrorInvalidValue;
  Segs segs;
  segs.n = n_segs;
  int trig_floats = 0;
  for (int s = 0; s < n_segs; ++s) {
    segs.off[s] = static_cast<const int*>(seg_off)[s];
    segs.heads[s] = static_cast<const int*>(seg_heads)[s];
    segs.hd[s] = static_cast<const int*>(seg_hd)[s];
    segs.inv_off[s] = static_cast<const int*>(seg_inv_off)[s];
    segs.trig_off[s] = trig_floats;
    trig_floats += segs.hd[s];
  }
  const size_t smem = sizeof(float) * (trig_floats > 0 ? trig_floats : 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const int* ps = static_cast<const int*>(pos);
  const float* iv = static_cast<const float*>(inv);
  if (dtype_code == 0) {
    gather_rope_rows<float><<<n, kThreads, smem, st>>>(
        static_cast<const float*>(table), id, ps, iv, static_cast<float*>(out), vocab,
        width, segs);
  } else if (dtype_code == 1) {
    gather_rope_rows<__nv_bfloat16><<<n, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(table), id, ps, iv,
        static_cast<__nv_bfloat16*>(out), vocab, width, segs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
