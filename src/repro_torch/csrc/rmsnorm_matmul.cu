// Fused RMSNorm + projection, for up to three weight matrices in one launch:
//   out_m[n, :] = (x[n] * rsqrt(mean(x[n]^2) + eps) * scale) @ w_m,   m < n_mats
// x (N, d), scale (d,), w_m (d, W_m), out_m (N, W_m), all row-major and of one
// dtype (float32 or bfloat16); the norm and the sums are fp32 and each output
// is cast to x's dtype once.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm_qkv.py
// (rmsnorm_matmul / _rmsnorm_matmul_kernel): LN1 plus the Q/K/V projection,
// the layer-0 work the precomputed table removes and every later layer's
// LN1+QKV. The TPU kernel multiplies by the column-concatenated [Wq|Wk|Wv];
// here the three matrices are separate pointers, so no caller concatenates
// 50 MB of weights a layer (mistral-7b width). blockIdx.x runs over the column
// tiles of all three in turn, so a narrow k or v matrix launches only its own
// tiles.
//
// Bound: operations at prefill sizes (N 8192 at mistral-7b width: 2*N*d*W =
// 412 GFLOP, 0.42 ms at 989 TFLOP/s), bytes at decode sizes (N 1: the 50.3 MB
// of weights, 15 us at 3.35 TB/s).
//
// Design: one block of 128 threads per 64x64 output tile of one matrix,
// walking d in steps of 32. The row's inverse RMS factors out of the dot
// product, out[n, c] = inv[n] * sum_k (x[n,k] * scale[k]) * w[k, c], so each
// block sums x^2 of its own 64 rows while it streams them (the TPU kernel
// also normalises per row block) and applies inv[n] in the epilogue: no
// first pass and no normalised copy of x in device memory. Loads are 16 bytes
// a thread where rows are 16-byte aligned, element-wise otherwise.
// bfloat16: the fp32 (x * scale) tile is split in shared memory into two
// bf16 tiles, hi = bf16(v) and lo = bf16(v - hi), and the product runs on
// the tensor cores through WMMA 16x16x16 fragments (mma.sync) with fp32
// accumulators as hi @ w + lo @ w: the weights are bf16 already, so this
// keeps 16 bits of the normalised row where one bf16 tile would keep 8 (the
// plain version keeps it in fp32), for twice the tensor-core work. Four
// warps of 32x32 each; the accumulators go through shared memory for the
// epilogue. float32: plain FMA, each thread a
// 4x8 block of the tile, the x tile stored transposed so the inner loop reads
// float4 rows of both tiles; no TF32, so fp32 results match the plain version
// to fp32 rounding. A later PR can pipeline the loads (cp.async or TMA) and
// move to wgmma; this one is the simple form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;

struct Mats {
  const void* w[3];
  void* out[3];
  int width[3];
  int tile_end[3];  // column tiles of matrices 0..m together
};

// the matrix of this block's column tile, and the tile's first column in it
__device__ __forceinline__ int pick(const Mats& mats, int& n0) {
  const int t = blockIdx.x;
  const int m = t < mats.tile_end[0] ? 0 : t < mats.tile_end[1] ? 1 : 2;
  n0 = (t - (m ? mats.tile_end[m - 1] : 0)) * kBN;
  return m;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// 16 consecutive elements of row `row` of a (rows, cols) matrix starting at
// column c0, as floats; zeros outside the matrix.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ m, int rows, int cols,
                                       int row, int c0, bool vec, float* v) {
  if (row < rows && vec && c0 + 16 <= cols) {
    const uint4* p = reinterpret_cast<const uint4*>(m + (long long)row * cols + c0);
    constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte load
#pragma unroll
    for (int u = 0; u < 16 / kPer; ++u) {
      uint4 raw = p[u];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[u * kPer + i] = to_f(e[i]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = c0 + i;
    v[i] = (row < rows && c < cols) ? to_f(m[(long long)row * cols + c]) : 0.f;
  }
}

// Loader roles (both paths): x tile kBM x kBK, thread t holds row t/2,
// columns (t%2)*16 .. +16; w tile kBK x kBN, thread t holds row t/4,
// columns (t%4)*16 .. +16.
__global__ void __launch_bounds__(kThreads)
rmsnorm_matmul_bf16(const bf16* __restrict__ x, const bf16* __restrict__ scale, Mats mats,
                    int N, int d, float eps, int x_vec, int w_vec_mask) {
  int n0;
  const int m = pick(mats, n0);
  const int Wm = mats.width[m];
  const int r0 = blockIdx.y * kBM;
  const bf16* __restrict__ w = static_cast<const bf16*>(mats.w[m]);
  bf16* __restrict__ out = static_cast<bf16*>(mats.out[m]);
  const bool w_vec = (w_vec_mask >> m) & 1;

  constexpr int kLdA = kBK + 8, kLdB = kBN + 8, kLdC = kBN + 4;
  __shared__ __align__(32) bf16 sA[2][kBM * kLdA];  // hi and lo parts
  __shared__ __align__(32) bf16 sB[kBK * kLdB];
  __shared__ __align__(32) float sC[kBM * kLdC];
  __shared__ float sInv[kBM];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int ar = tid >> 1, ac = (tid & 1) * 16;
  const int br = tid >> 2, bc = (tid & 3) * 16;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  float ssq = 0.f;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    float v[16];
    load16(x, N, d, r0 + ar, k0 + ac, x_vec, v);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = k0 + ac + i;
      ssq += v[i] * v[i];
      const float a = v[i] * (k < d ? to_f(scale[k]) : 0.f);
      const bf16 hi = __float2bfloat16(a);
      sA[0][ar * kLdA + ac + i] = hi;
      sA[1][ar * kLdA + ac + i] = __float2bfloat16(a - __bfloat162float(hi));
    }
    load16(w + (long long)k0 * Wm, d - k0, Wm, br, n0 + bc, w_vec, v);
#pragma unroll
    for (int i = 0; i < 16; ++i) sB[br * kLdB + bc + i] = __float2bfloat16(v[i]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2][2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[part][i], sA[part] + (wr + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sB + kk * kLdB + wc + 16 * j, kLdB);
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[part][i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  ssq += __shfl_xor_sync(0xffffffffu, ssq, 1);
  if ((tid & 1) == 0) sInv[ar] = 1.f / sqrtf(ssq / (float)d + eps);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wr + 16 * i) * kLdC + wc + 16 * j, acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN, c = e % kBN;
    if (r0 + r < N && n0 + c < Wm)
      out[(long long)(r0 + r) * Wm + n0 + c] = __float2bfloat16(sC[r * kLdC + c] * sInv[r]);
  }
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_matmul_f32(const float* __restrict__ x, const float* __restrict__ scale, Mats mats,
                   int N, int d, float eps, int x_vec, int w_vec_mask) {
  int n0;
  const int m = pick(mats, n0);
  const int Wm = mats.width[m];
  const int r0 = blockIdx.y * kBM;
  const float* __restrict__ w = static_cast<const float*>(mats.w[m]);
  float* __restrict__ out = static_cast<float*>(mats.out[m]);
  const bool w_vec = (w_vec_mask >> m) & 1;

  constexpr int kLdA = kBM + 4, kLdB = kBN + 4;
  __shared__ __align__(16) float sAt[kBK * kLdA];  // (x * scale) tile, transposed
  __shared__ __align__(16) float sB[kBK * kLdB];
  __shared__ float sInv[kBM];

  const int tid = threadIdx.x;
  const int ar = tid >> 1, ac = (tid & 1) * 16;
  const int br = tid >> 2, bc = (tid & 3) * 16;
  const int ty = tid >> 3, tx = tid & 7;  // rows ty*4 .. +4; cols tx*4 and 32 + tx*4

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ssq = 0.f;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    float v[16];
    load16(x, N, d, r0 + ar, k0 + ac, x_vec, v);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = k0 + ac + i;
      ssq += v[i] * v[i];
      sAt[(ac + i) * kLdA + ar] = v[i] * (k < d ? scale[k] : 0.f);
    }
    load16(w + (long long)k0 * Wm, d - k0, Wm, br, n0 + bc, w_vec, v);
#pragma unroll
    for (int i = 0; i < 16; ++i) sB[br * kLdB + bc + i] = v[i];
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(sAt + kk * kLdA + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sB + kk * kLdB + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sB + kk * kLdB + 32 + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  ssq += __shfl_xor_sync(0xffffffffu, ssq, 1);
  if ((tid & 1) == 0) sInv[ar] = 1.f / sqrtf(ssq / (float)d + eps);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r0 + r >= N) continue;
    const float inv = sInv[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4);
      if (n0 + c < Wm) out[(long long)(r0 + r) * Wm + n0 + c] = acc[i][j] * inv;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (N, d), scale (d,), n_mats (1-3) weights w_m (d, W_m) with outputs
// out_m (N, W_m); dtype_code 0 = float32, 1 = bfloat16 (all tensors).
extern "C" int rmsnorm_matmul(const void* x, const void* scale, const void* w0,
                              const void* w1, const void* w2, void* o0, void* o1,
                              void* o2, int W0, int W1, int W2, int n_mats, int N,
                              int d, float eps, int dtype_code, void* stream) {
  if (N <= 0 || n_mats <= 0) return 0;
  if (n_mats > 3 || d <= 0) return (int)cudaErrorInvalidValue;
  Mats mats;
  const void* ws[3] = {w0, w1, w2};
  void* os[3] = {o0, o1, o2};
  const int Ws[3] = {W0, W1, W2};
  const int es = dtype_code == 0 ? 4 : 2;
  int tiles = 0, w_vec_mask = 0;
  for (int m = 0; m < 3; ++m) {
    mats.w[m] = m < n_mats ? ws[m] : nullptr;
    mats.out[m] = m < n_mats ? os[m] : nullptr;
    mats.width[m] = m < n_mats ? Ws[m] : 0;
    if (m < n_mats) {
      if (Ws[m] < 0) return (int)cudaErrorInvalidValue;
      tiles += (Ws[m] + kBN - 1) / kBN;
      if (aligned16(ws[m]) && ((long long)Ws[m] * es) % 16 == 0) w_vec_mask |= 1 << m;
    }
    mats.tile_end[m] = tiles;
  }
  if (tiles == 0) return 0;
  const int x_vec = aligned16(x) && ((long long)d * es) % 16 == 0;
  dim3 grid(tiles, (N + kBM - 1) / kBM, 1);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    rmsnorm_matmul_f32<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                 static_cast<const float*>(scale), mats, N,
                                                 d, eps, x_vec, w_vec_mask);
  else if (dtype_code == 1)
    rmsnorm_matmul_bf16<<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(x),
                                                        static_cast<const bf16*>(scale),
                                                        mats, N, d, eps, x_vec, w_vec_mask);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
