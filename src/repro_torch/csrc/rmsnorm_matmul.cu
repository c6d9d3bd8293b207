// Fused RMSNorm + projection, for up to three weight matrices in one call:
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
// 50 MB of weights a layer (mistral-7b width). Column tiles of all three run
// in turn over one grid axis (Mats / pick), so a narrow k or v matrix
// launches only its own tiles.
//
// Bound: operations at prefill sizes (N 8192 at mistral-7b width: 2*N*d*W =
// 412 GFLOP, 0.42 ms at 989 TFLOP/s; the bf16 forms below do the product
// twice), bytes at decode sizes (N 1: the 50.3 MB of weights, 15 us at
// 3.35 TB/s).
//
// bfloat16 keeps 16 bits of the normalised row xn: it is split into hi =
// bf16(xn) and lo = bf16(xn - hi), and the product runs as hi @ w + lo @ w
// on the tensor cores (the weights are bf16 already), or in fp32 on the FMA
// units at decode sizes. One call runs one of three forms, chosen by shape in
// plan() (never by a failed launch):
//
// - wgmma (bf16, N > kSplitKMaxN; d and every W_m multiples of 8, weights
//   16-byte aligned): a row kernel (rms_rows) writes hi and lo, (N, d) bf16
//   each, into the caller's workspace; then a Hopper GEMM (gemm_hilo): one
//   block per 128 x 256 output tile, one producer warp keeping TMA loads of
//   the hi, lo and weight tiles in flight over a 3-stage mbarrier ring (128-
//   byte swizzle), two consumer warpgroups of 64 rows each issuing wgmma
//   m64n256k16 twice per k step, hi then lo, on one weight tile into one set
//   of fp32 accumulators. The weights are (d, W) row-major, so B is MN-major
//   (the transpose flag). TMA fills zeros outside x and w; the epilogue
//   stores bounded by N and W_m. Where the output tiles do not fill the
//   card (one row tile at N <= 128), d is cut into K slices (gemm_splits)
//   whose fp32 partials splitk_combine sums in slice order.
// - split-K (bf16, N <= kSplitKMaxN, the same widths; fp32 rows, no hi/lo):
//   as the tiled form, the row's inverse RMS factors out of the product.
//   splitk_partial runs one block per (256-column tile, 128-long slice of
//   d): it puts x[n, k] * scale[k] of its slice in shared memory in fp32;
//   each lane streams 16 bytes (8 columns) of a weight row per k, all of a
//   round's 8-16 rows in flight, times those values for up to 8 rows n at
//   once, and the block writes the slice's fp32 partial; the blocks of
//   column tile 0 also write the slice's sums of x^2. splitk_combine sums
//   the partials and the sums of squares in slice order (deterministic),
//   applies inv[n] and casts. Two device kernels. The slices depend on d
//   alone (splitk_splits), so a row's bits do not depend on N.
// - tiled (float32 always, bf16 of other widths or alignments): one
//   block of 128 threads per 64x64 output tile, walking d in steps of 32;
//   the row's inverse RMS factors out of the product, out[n, c] = inv[n] *
//   sum_k (x[n,k] * scale[k]) * w[k, c], so each block sums x^2 of its own
//   rows and applies inv[n] in the epilogue. bf16: the (x * scale) tile is
//   split into hi/lo in shared memory and multiplied through WMMA 16x16x16
//   fragments; fp32: plain FMA, each thread a 4x8 block, no TF32.
//
// The wgmma and split-K forms are two or three device kernels; the wrapper
// counts the call once. Crossover: kSplitKMaxN, from the times of both forms
// at N 1-64 (scripts/rmsnorm_mutants.py).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <mma.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;

// forms (plan), as the wrapper names them
constexpr int kFormTiled = 0, kFormSplitK = 1, kFormWgmma = 2;

struct Mats {
  const void* w[3];
  void* out[3];
  int width[3];
  int tile_end[3];  // column tiles of matrices 0..m together
  int col_off[3];   // first column of matrix m in [W_0 | W_1 | W_2]
};

// the matrix of this block's column tile (bn columns wide), and the tile's
// first column in it
__device__ __forceinline__ int pick(const Mats& mats, int& n0, int bn) {
  const int t = blockIdx.x;
  const int m = t < mats.tile_end[0] ? 0 : t < mats.tile_end[1] ? 1 : 2;
  n0 = (t - (m ? mats.tile_end[m - 1] : 0)) * bn;
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
  const int m = pick(mats, n0, kBN);
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
  const int m = pick(mats, n0, kBN);
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

// ------------------------------------------------ rows: the norm, in fp32
constexpr int kRowThreads = 256;

// 8 bf16 of a 16-byte word as floats
__device__ __forceinline__ void unpack8(const uint4& raw, float* v) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

// One block per row n: xn = (x[n] * inv) * scale with inv = 1 / sqrt(sum(x^2)
// / d + eps), in fp32 (the plain version's order), written as hi = bf16(xn)
// and lo = bf16(xn - hi), (N, d) bf16 each. vec: x, scale, hi and lo 16-byte
// aligned and d % 8 == 0.
__global__ void __launch_bounds__(kRowThreads)
rms_rows(const bf16* __restrict__ x, const bf16* __restrict__ scale, int d, float eps,
         int vec, bf16* __restrict__ hi, bf16* __restrict__ lo) {
  const long long row = blockIdx.x;
  const bf16* __restrict__ xr = x + row * d;
  const int tid = threadIdx.x;
  float ssq = 0.f;
  if (vec) {
    for (int c = tid * 8; c < d; c += kRowThreads * 8) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) ssq += v[i] * v[i];
    }
  } else {
    for (int c = tid; c < d; c += kRowThreads) {
      const float v = __bfloat162float(xr[c]);
      ssq += v * v;
    }
  }
  __shared__ float part[kRowThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ssq += __shfl_xor_sync(0xffffffffu, ssq, o);
  if ((tid & 31) == 0) part[tid >> 5] = ssq;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) tot += part[w];
  const float inv = 1.f / sqrtf(tot / (float)d + eps);
  if (vec) {
    for (int c = tid * 8; c < d; c += kRowThreads * 8) {
      float v[8], s[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
      unpack8(*reinterpret_cast<const uint4*>(scale + c), s);
      uint4 h, l;
      bf16* he = reinterpret_cast<bf16*>(&h);
      bf16* le = reinterpret_cast<bf16*>(&l);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xn = v[i] * inv * s[i];
        he[i] = __float2bfloat16(xn);
        le[i] = __float2bfloat16(xn - __bfloat162float(he[i]));
      }
      *reinterpret_cast<uint4*>(hi + row * d + c) = h;
      *reinterpret_cast<uint4*>(lo + row * d + c) = l;
    }
  } else {
    for (int c = tid; c < d; c += kRowThreads) {
      const float xn = __bfloat162float(xr[c]) * inv * __bfloat162float(scale[c]);
      const bf16 h = __float2bfloat16(xn);
      hi[row * d + c] = h;
      lo[row * d + c] = __float2bfloat16(xn - __bfloat162float(h));
    }
  }
}

// ------------------------------------------- split-K: decode-sized N
constexpr int kSkCols = 256;      // columns of a block: 32 lanes x 8
constexpr int kSkThreads = 256;   // 8 warps, each every 8th k of the slice
constexpr int kSkWarps = kSkThreads / 32;
constexpr int kSkSlice = 128;     // k of a slice, at most (shared x * scale rows)
constexpr int kSkRows = 8;        // rows n a pass keeps in registers
// bf16 calls of at most this many rows (one pass of splitk_partial) take
// split-K, the others wgmma
constexpr int kSplitKMaxN = kSkRows;

// slices of d: ceil(d / kSkSlice), each ceil(d / splits) long (the last
// shorter or empty). At mistral-7b width 32 slices x 24 column tiles = 768
// blocks, all resident at once on 132 SMs, each warp 16 weight rows.
int splitk_splits(int d) { return (d + kSkSlice - 1) / kSkSlice; }

// part[s, n, col_off[m] + c] = sum over k in slice s of (x[n, k] * scale[k])
// w_m[k, c], and, from the blocks of column tile 0, ssq[s, n] = sum over k in
// slice s of x[n, k]^2 (the row's inverse RMS factors out of the product and
// splitk_combine applies it). NR rows a pass, kUnroll weight rows in flight a
// lane (registers: NR * 8 accumulators and kUnroll * 4 words of weights).
template <int NR, int kUnroll = NR <= 2 ? 16 : 8>
__global__ void __launch_bounds__(kSkThreads)
splitk_partial(const bf16* __restrict__ x, const bf16* __restrict__ scale, Mats mats, int N,
               int d, int slice, int wtot, float* __restrict__ part, float* __restrict__ ssq) {
  int n0;
  const int m = pick(mats, n0, kSkCols);
  const int Wm = mats.width[m];
  const bf16* __restrict__ w = static_cast<const bf16*>(mats.w[m]);
  const int s = blockIdx.y;
  const int k0 = s * slice;
  const int k1 = min(d, k0 + slice);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = n0 + lane * 8;
  const bool valid = c < Wm;  // W_m % 8 == 0: all 8 columns or none
  __shared__ float sx[NR][kSkSlice];
  __shared__ float red[kSkWarps][kSkCols];
  for (int r0 = 0; r0 < N; r0 += NR) {
    __syncthreads();
    for (int e = tid; e < NR * slice; e += kSkThreads) {
      const int r = e / slice, k = e % slice;
      sx[r][k] = (r0 + r < N && k0 + k < k1)
                     ? __bfloat162float(x[(long long)(r0 + r) * d + k0 + k]) *
                           __bfloat162float(scale[k0 + k])
                     : 0.f;
    }
    if (blockIdx.x == 0)  // warp r: x^2 of row r0 + r over the slice
      for (int r = warp; r < NR && r0 + r < N; r += kSkWarps) {
        float q = 0.f;
        for (int k = k0 + lane; k < k1; k += 32) {
          const float v = __bfloat162float(x[(long long)(r0 + r) * d + k]);
          q += v * v;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
        if (lane == 0) ssq[(long long)s * N + r0 + r] = q;
      }
    __syncthreads();
    float acc[NR][8];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
    // every round has all its loads in flight: kUnroll weight rows a lane
    for (int k = k0 + warp; k < k1; k += kSkWarps * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ku = k + kSkWarps * u;
        raw[u] = valid && ku < k1
                     ? __ldg(reinterpret_cast<const uint4*>(w + (long long)ku * Wm + c))
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + kSkWarps * u >= k1) break;
        float wf[8];
        unpack8(raw[u], wf);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float xv = sx[r][k + kSkWarps * u - k0];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(xv, wf[i], acc[r][i]);
        }
      }
    }
    // the 8 warps' sums, in warp order
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) red[warp][lane * 8 + i] = acc[r][i];
      __syncthreads();
      const int col = n0 + tid;
      if (r0 + r < N && col < Wm) {
        float sum = 0.f;
#pragma unroll
        for (int v = 0; v < kSkWarps; ++v) sum += red[v][tid];
        part[((long long)s * N + r0 + r) * wtot + mats.col_off[m] + col] = sum;
      }
      __syncthreads();
    }
  }
}

// out_m[n, c] = bf16(sum over s, in order, of part[s, n, col_off[m] + c]),
// times inv[n] = 1 / sqrt(sum over s, in order, of ssq[s, n] / d + eps) where
// ssq is given (the split-K form; the GEMM's partials are normalised)
__global__ void splitk_combine(const float* __restrict__ part, const float* __restrict__ ssq,
                               Mats mats, int N, int d, float eps, int wtot, int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)N * wtot) return;
  const int n = (int)(e / wtot), c = (int)(e % wtot);
  const int m = c < mats.col_off[1] ? 0 : c < mats.col_off[2] ? 1 : 2;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[((long long)s * N + n) * wtot + c];
  if (ssq) {
    float tot = 0.f;
    for (int s = 0; s < splits; ++s) tot += ssq[(long long)s * N + n];
    sum *= 1.f / sqrtf(tot / (float)d + eps);
  }
  static_cast<bf16*>(mats.out[m])[(long long)n * mats.width[m] + c - mats.col_off[m]] =
      __float2bfloat16(sum);
}

// ------------------------------------ wgmma + TMA: prefill-sized N
constexpr int gBM = 128, gBN = 256, gBK = 64, gStages = 3;
constexpr int gThreads = 384;  // warpgroup 0: the producer; 1 and 2: consumers
constexpr unsigned gATile = gBM * gBK * 2;         // 16 KB: hi or lo
constexpr unsigned gBBox = gBK * 64 * 2;           // 8 KB: 64 k rows x 64 columns
constexpr unsigned gBTile = gBBox * (gBN / 64);    // 32 KB
constexpr unsigned gStage = 2 * gATile + gBTile;   // 64 KB
constexpr unsigned gSmem = gStages * gStage + 1024 + 2 * gStages * 8;

__global__ void __launch_bounds__(gThreads, 1)
gemm_hilo(__grid_constant__ const CUtensorMap a_hi, __grid_constant__ const CUtensorMap a_lo,
          __grid_constant__ const CUtensorMap b0, __grid_constant__ const CUtensorMap b1,
          __grid_constant__ const CUtensorMap b2, Mats mats, int N, int d, int kt_per,
          float* __restrict__ part, int wtot) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles want 1024-byte aligned bases
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + gStages * gStage);
  uint64_t* empty = full + gStages;
  int n0;
  const int m = pick(mats, n0, gBN);
  const int r0 = blockIdx.y * gBM;
  // this block's k tiles: all of d, or slice blockIdx.z of kt_per tiles
  const int kt0 = blockIdx.z * kt_per;
  const int kt_n = min((d + gBK - 1) / gBK - kt0, kt_per);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < gStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // each consumer warp releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const CUtensorMap* bm = m == 0 ? &b0 : m == 1 ? &b1 : &b2;
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % gStages;
        if (kt >= gStages) mbar_wait(&empty[s], ((kt / gStages) - 1) & 1);
        uint8_t* st = smem + s * gStage;
        const int k = (kt0 + kt) * gBK;
        mbar_expect_tx(&full[s], gStage);
        tma_load_2d(st, &a_hi, &full[s], k, r0);
        tma_load_2d(st + gATile, &a_lo, &full[s], k, r0);
#pragma unroll
        for (int j = 0; j < gBN / 64; ++j)
          tma_load_2d(st + 2 * gATile + j * gBBox, bm, &full[s], n0 + 64 * j, k);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // rows 64c .. 64c + 63 of the tile
    float acc[128];  // set by the first product (accumulate 0); kt_n >= 1
    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % gStages;
      mbar_wait(&full[s], (kt / gStages) & 1);
      const uint8_t* st = smem + s * gStage;
      const uint8_t* ahi = st + c * 64 * 128;  // 64 rows of 128 bytes
      const uint8_t* alo = ahi + gATile;
      const uint8_t* bt = st + 2 * gATile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < gBK / 16; ++kk) {
        // A: K-major, k advances 32 bytes in the swizzled 128-byte row;
        // 8-row groups 1024 bytes apart. B: MN-major, 16 k rows = 2048
        // bytes; 64-column boxes gBBox apart, 8-k-row groups 1024.
        const uint64_t db = wgmma_desc_sw128(bt + kk * 2048, gBBox, 1024);
        wgmma_m64n256k16(acc, wgmma_desc_sw128(ahi + kk * 32, 16, 1024), db, kt | kk);
        wgmma_m64n256k16(acc, wgmma_desc_sw128(alo + kk * 32, 16, 1024), db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > 0 && (threadIdx.x & 31) == 0) mbar_arrive(&empty[(kt - 1) % gStages]);
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    const int Wm = mats.width[m];
    bf16* __restrict__ out = static_cast<bf16*>(mats.out[m]);
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int ra = r0 + c * 64 + warp * 16 + (lane >> 2), rb = ra + 8;
    if (part) {  // the slice's fp32 partial, for splitk_combine
      float* pz = part + (long long)blockIdx.z * N * wtot + mats.col_off[m];
#pragma unroll
      for (int j = 0; j < gBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col < Wm) {
          if (ra < N)
            *reinterpret_cast<float2*>(pz + (long long)ra * wtot + col) =
                make_float2(acc[4 * j], acc[4 * j + 1]);
          if (rb < N)
            *reinterpret_cast<float2*>(pz + (long long)rb * wtot + col) =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < gBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col < Wm) {  // W_m % 8 == 0: both columns or neither
        if (ra < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)ra * Wm + col) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (rb < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)rb * Wm + col) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// loaded (no link flag)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// a row-major (outer, inner) bf16 matrix in boxes of (box_outer, 64), 128-
// byte swizzle, zeros outside
bool tensor_map(CUtensorMap* map, const void* p, int inner, int outer, int box_outer) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Mats over n_mats matrices in column tiles `bn` wide; -> tiles
int make_mats(Mats& mats, const void* const* ws, void* const* os, const int* Ws, int n_mats,
              int bn) {
  int tiles = 0, off = 0;
  for (int m = 0; m < 3; ++m) {
    const bool on = m < n_mats;
    mats.w[m] = on ? ws[m] : nullptr;
    mats.out[m] = on ? os[m] : nullptr;
    mats.width[m] = on ? Ws[m] : 0;
    mats.col_off[m] = off;
    if (on) {
      tiles += (Ws[m] + bn - 1) / bn;
      off += Ws[m];
    }
    mats.tile_end[m] = tiles;
  }
  return tiles;
}

// K slices of the GEMM: one where the output tiles fill the card's 132 SMs,
// else about two blocks an SM (decode-sized N gives one row tile); writes the
// k tiles of a slice to *kt_per
int gemm_splits(int N, int d, int tiles, int* kt_per) {
  const int kt = (d + gBK - 1) / gBK;
  const long long blocks = (long long)tiles * ((N + gBM - 1) / gBM);
  int s = blocks >= 132 ? 1 : (int)((2 * 132 + blocks - 1) / blocks);
  if (s > kt) s = kt;
  *kt_per = (kt + s - 1) / s;
  return (kt + *kt_per - 1) / *kt_per;
}

// The form a call takes (kForm*; `want` < 0: chosen by shape, else that form
// or -1 if the shape does not allow it) and the workspace bytes it needs.
int plan(const void* const* ws, const int* Ws, int n_mats, int N, int d, int dtype_code,
         int want, long long* ws_bytes) {
  *ws_bytes = 0;
  bool fits = dtype_code == 1 && d % 8 == 0 && N > 0;
  int wtot = 0, tiles = 0;
  for (int m = 0; m < n_mats; ++m) {
    fits = fits && Ws[m] > 0 && Ws[m] % 8 == 0 && aligned16(ws[m]);
    wtot += Ws[m];
    tiles += (Ws[m] + gBN - 1) / gBN;
  }
  const int form = want >= 0 ? want : !fits ? kFormTiled
                                  : N <= kSplitKMaxN ? kFormSplitK : kFormWgmma;
  if (form != kFormTiled && !fits) return -1;
  int kt_per;
  if (form == kFormSplitK) {
    *ws_bytes = 4ll * splitk_splits(d) * N * (wtot + 1);  // partials and ssq
  } else if (form == kFormWgmma) {  // hi and lo, and the slices' partials
    const int splits = gemm_splits(N, d, tiles, &kt_per);
    *ws_bytes = 4ll * N * d + (splits > 1 ? 4ll * splits * N * wtot : 0);
  } else if (form != kFormTiled) {
    return -1;
  }
  return form;
}

}  // namespace

// The form (0 tiled, 1 split-K, 2 wgmma) of an rmsnorm_matmul call with
// these arguments, or -1 if `want` (>= 0) is not allowed for them; writes the
// workspace bytes it needs to *ws_bytes.
extern "C" int rmsnorm_matmul_plan(const void* w0, const void* w1, const void* w2, int W0,
                                   int W1, int W2, int n_mats, int N, int d, int dtype_code,
                                   int want, long long* ws_bytes) {
  const void* ws[3] = {w0, w1, w2};
  const int Ws[3] = {W0, W1, W2};
  if (n_mats < 1 || n_mats > 3) return -1;
  return plan(ws, Ws, n_mats, N, d, dtype_code, want, ws_bytes);
}

// x (N, d), scale (d,), n_mats (1-3) weights w_m (d, W_m) with outputs
// out_m (N, W_m); dtype_code 0 = float32, 1 = bfloat16 (all tensors); form
// as rmsnorm_matmul_plan (-1: by shape); workspace: the bytes plan asks for.
extern "C" int rmsnorm_matmul(const void* x, const void* scale, const void* w0,
                              const void* w1, const void* w2, void* o0, void* o1,
                              void* o2, int W0, int W1, int W2, int n_mats, int N,
                              int d, float eps, int dtype_code, int form, void* workspace,
                              long long ws_bytes, void* stream) {
  if (N <= 0 || n_mats <= 0) return 0;
  if (n_mats > 3 || d <= 0) return (int)cudaErrorInvalidValue;
  const void* ws[3] = {w0, w1, w2};
  void* os[3] = {o0, o1, o2};
  const int Ws[3] = {W0, W1, W2};
  for (int m = 0; m < n_mats; ++m)
    if (Ws[m] < 0) return (int)cudaErrorInvalidValue;
  long long need;
  form = plan(ws, Ws, n_mats, N, d, dtype_code, form, &need);
  if (form < 0 || ws_bytes < need || (need && !aligned16(workspace)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* sb = static_cast<const bf16*>(scale);
  const int row_vec = aligned16(x) && aligned16(scale) && d % 8 == 0;
  Mats mats;
  if (form == kFormSplitK) {
    const int tiles = make_mats(mats, ws, os, Ws, n_mats, kSkCols);
    const int wtot = W0 + (n_mats > 1 ? W1 : 0) + (n_mats > 2 ? W2 : 0);
    if (tiles == 0) return 0;
    const int splits = splitk_splits(d);
    const int slice = (d + splits - 1) / splits;
    float* part = static_cast<float*>(workspace);
    float* ssq = part + (long long)splits * N * wtot;
    const dim3 grid(tiles, splits);
    if (N >= kSkRows)
      splitk_partial<kSkRows><<<grid, kSkThreads, 0, s>>>(xb, sb, mats, N, d, slice, wtot, part,
                                                          ssq);
    else if (N >= 4)
      splitk_partial<4><<<grid, kSkThreads, 0, s>>>(xb, sb, mats, N, d, slice, wtot, part, ssq);
    else if (N >= 2)
      splitk_partial<2><<<grid, kSkThreads, 0, s>>>(xb, sb, mats, N, d, slice, wtot, part, ssq);
    else
      splitk_partial<1><<<grid, kSkThreads, 0, s>>>(xb, sb, mats, N, d, slice, wtot, part, ssq);
    const long long n_out = (long long)N * wtot;
    splitk_combine<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(part, ssq, mats, N, d, eps,
                                                                   wtot, splits);
    return (int)cudaGetLastError();
  }
  if (form == kFormWgmma) {
    const int tiles = make_mats(mats, ws, os, Ws, n_mats, gBN);
    const unsigned row_tiles = (N + gBM - 1) / gBM;
    if (tiles == 0) return 0;
    if (row_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
    const int wtot = W0 + (n_mats > 1 ? W1 : 0) + (n_mats > 2 ? W2 : 0);
    int kt_per;
    const int splits = gemm_splits(N, d, tiles, &kt_per);
    bf16* hi = static_cast<bf16*>(workspace);
    bf16* lo = hi + (long long)N * d;
    float* part = splits > 1 ? reinterpret_cast<float*>(lo + (long long)N * d) : nullptr;
    CUtensorMap ma[2], mb[3];
    bool ok = tensor_map(&ma[0], hi, d, N, gBM) && tensor_map(&ma[1], lo, d, N, gBM);
    for (int m = 0; m < 3; ++m)
      ok = ok && tensor_map(&mb[m], m < n_mats ? ws[m] : ws[0], m < n_mats ? Ws[m] : W0, d, gBK);
    if (!ok) return (int)cudaErrorInvalidValue;
    rms_rows<<<N, kRowThreads, 0, s>>>(xb, sb, d, eps, row_vec, hi, lo);
    cudaError_t e = cudaFuncSetAttribute(gemm_hilo, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)gSmem);
    if (e != cudaSuccess) return (int)e;
    gemm_hilo<<<dim3(tiles, row_tiles, splits), gThreads, gSmem, s>>>(
        ma[0], ma[1], mb[0], mb[1], mb[2], mats, N, d, kt_per, part, wtot);
    if (part) {
      const long long n_out = (long long)N * wtot;
      splitk_combine<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(part, nullptr, mats, N, d,
                                                                     eps, wtot, splits);
    }
    return (int)cudaGetLastError();
  }
  const int es = dtype_code == 0 ? 4 : 2;
  const int tiles = make_mats(mats, ws, os, Ws, n_mats, kBN);
  int w_vec_mask = 0;
  for (int m = 0; m < n_mats; ++m)
    if (aligned16(ws[m]) && ((long long)Ws[m] * es) % 16 == 0) w_vec_mask |= 1 << m;
  if (tiles == 0) return 0;
  const int x_vec = aligned16(x) && ((long long)d * es) % 16 == 0;
  dim3 grid(tiles, (N + kBM - 1) / kBM, 1);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  if (dtype_code == 0)
    rmsnorm_matmul_f32<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                 static_cast<const float*>(scale), mats, N,
                                                 d, eps, x_vec, w_vec_mask);
  else if (dtype_code == 1)
    rmsnorm_matmul_bf16<<<grid, kThreads, 0, s>>>(xb, sb, mats, N, d, eps, x_vec, w_vec_mask);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
