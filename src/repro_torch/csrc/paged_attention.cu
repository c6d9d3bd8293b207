// In-place paged attention of a whole query chunk (non-quantised, non-MLA):
//   out[b, t, h, g, :] = softmax_j(q[b,t,h,g]·k_j * scale) · v_j
// over the keys j of slot b's pages, read through the page table
// (page table[b, j / ps], row j % ps), where a key is valid iff its stored
// position c satisfies c >= 0, c <= pos0[b] + t and, with a window,
// pos0[b] + t - c < window. Rows with no valid key come out as zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention / _paged_kernel, without the int8 `quant` and MLA
// `mla_split` variants). There the grid is (slot, kv head, page) and the
// running softmax lives in scratch carried along the sequential page axis.
//
// Bound: bytes at serving shapes. Each (slot, kv head) reads its K and V
// once, while the T*G query rows (4 at decode, 64 at a 16-token prefill
// chunk with G = 4) give only 2*T*G flops per K/V element read, far below
// the card's ratio of compute to bandwidth.
//
// Design: the T*G query rows of one (slot, kv head) are split into tiles of
// at most kRowTile = 64 rows, one block per (slot, kv head, row tile), so any
// chunk length and group size fit (glm4-9b's 16-token chunks at G = 16 are
// 256 rows: four blocks) and the grid grows with the chunk. Each block keeps
// its rows in shared memory and walks the slot's virtual cache in tiles of
// 32 keys; that loop replaces the TPU's sequential grid axis. Every block
// reads the slot's K/V for its own rows (from L2 after the first). A tile's keys are addressed row
// by row through the table, so any page size works the same (including the
// page size of 1 that an odd ring length forces on the dense view) and no
// gathered copy of the cache is ever made. A tile whose 32 stored positions
// are all unusable for every query row (empty ring slots, beyond the
// chunk, outside the window) is skipped before its K/V are read; a skipped
// tile would change no row's running state, so the split into row tiles
// leaves every row's result bit for bit as with one block. Scores,
// the running max, the running sum and the accumulator are fp32; the
// softmax is one warp per query row with shuffle reductions. The running
// max starts at NEG_INF = -2^30 and invalid probabilities are forced to 0,
// as in the Pallas kernel, so a row with no valid key ends with l = 0 and
// writes 0 / max(l, 1e-30) = 0. K rows are padded by one float in shared
// memory so the score loop (lanes on different keys) is free of bank
// conflicts. The shared footprint of a 64-row tile (about 105 KB at
// d = 128) is above the 48 KB static limit, so it is dynamic shared memory
// opted in with cudaFuncSetAttribute; d may be anything up to the footprint
// limit (16 in the smoke configs, 128 at full width, up to about 280).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // keys per tile = one warp lane per key in the softmax
constexpr int kRowTile = 64;  // query rows per block
constexpr float kNegInf = -1073741824.0f;  // -2^30, as NEG_INF in the Pallas kernel
constexpr int kMaxSmem = 232448;           // 227 KB per block on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool usable(int c, int qp, int window) {
  return c >= 0 && c <= qp && (window == 0 || qp - c < window);
}

size_t smem_floats(int R, int d) {
  R = R < kRowTile ? R : kRowTile;  // rows one block holds
  return (size_t)R * (d + 1)      // q rows
         + (size_t)R * d          // accumulator
         + (size_t)kTile * (d + 1)  // K tile (padded)
         + (size_t)kTile * d      // V tile
         + (size_t)R * kTile      // scores / probabilities
         + 3 * (size_t)R          // m, l, correction
         + 2 * (size_t)kTile;     // stored positions, row addresses (int)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ cpos,
                       const int* __restrict__ table, const int* __restrict__ pos0,
                       T* __restrict__ out, int T_, int KV, int G, int d, int ps, int P,
                       float scale, int window) {
  extern __shared__ float smem[];
  const int R = T_ * G;
  const int r0 = blockIdx.y * kRowTile;          // first row of this block
  const int Rb = min(kRowTile, R - r0);          // rows of this block
  const int Rs = min(kRowTile, R);               // rows the layout holds
  float* sQ = smem;
  float* sAcc = sQ + Rs * (d + 1);
  float* sK = sAcc + Rs * d;
  float* sV = sK + kTile * (d + 1);
  float* sS = sV + kTile * d;
  float* sM = sS + Rs * kTile;
  float* sL = sM + Rs;
  float* sCorr = sL + Rs;
  int* sPos = reinterpret_cast<int*>(sCorr + Rs);
  int* sRow = sPos + kTile;

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = pos0[b];
  const int S = P * ps;
  // the loosest rows of this block: its last lane for causality, its first
  // for the window
  const int t_lo = r0 / G, t_hi = (r0 + Rb - 1) / G;

  for (int i = tid; i < Rb * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int t = (r0 + r) / G, g = (r0 + r) % G;
    sQ[r * (d + 1) + c] = to_f(q[((((long long)b * T_ + t) * KV + h) * G + g) * d + c]);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < Rb; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    bool live = false;
    if (tid < kTile) {
      const int j = k0 + tid;
      int c = -1, row = 0;
      if (j < S) {
        const int page = table[(long long)b * P + j / ps];
        row = page * ps + j % ps;
        c = cpos[row];
      }
      sPos[tid] = c;
      sRow[tid] = row;
      live = c >= 0 && c <= p0 + t_hi && (window == 0 || p0 + t_lo - c < window);
    }
    if (!__syncthreads_or(live)) continue;

    for (int i = tid; i < kTile * d; i += kThreads) {
      const int j = i / d, c = i % d;
      float kv_k = 0.f, kv_v = 0.f;
      if (sPos[j] >= 0) {
        const long long off = ((long long)sRow[j] * KV + h) * d + c;
        kv_k = to_f(k[off]);
        kv_v = to_f(v[off]);
      }
      sK[j * (d + 1) + c] = kv_k;
      sV[j * d + c] = kv_v;
    }
    __syncthreads();

    for (int i = tid; i < Rb * kTile; i += kThreads) {
      const int r = i / kTile, j = i % kTile;
      float s = kNegInf;
      if (usable(sPos[j], p0 + (r0 + r) / G, window)) {
        const float* qr = sQ + r * (d + 1);
        const float* kr = sK + j * (d + 1);
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
        s = dot * scale;
      }
      sS[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < Rb; r += kWarps) {
      const bool ok = usable(sPos[lane], p0 + (r0 + r) / G, window);
      const float s = sS[r * kTile + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = ok ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sS[r * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sCorr[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < Rb * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const float* pr = sS + r * kTile;
      float pv = 0.f;
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) pv += pr[j] * sV[j * d + c];
      sAcc[i] = sAcc[i] * sCorr[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < Rb * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int t = (r0 + r) / G, g = (r0 + r) % G;
    const float l = fmaxf(sL[r], 1e-30f);
    out[((((long long)b * T_ + t) * KV + h) * G + g) * d + c] = from_f<T>(sAcc[i] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* cpos,
                   const int* table, const int* pos0, void* out, int B, int T_, int KV,
                   int G, int d, int ps, int P, float scale, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(T_ * G, d) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidConfiguration;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const dim3 grid(B * KV, (T_ * G + kRowTile - 1) / kRowTile);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), cpos,
      table, pos0, static_cast<T*>(out), T_, KV, G, d, ps, P, scale, window);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (q, K, V and the output share it).
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* cpos, const void* table, const void* pos0,
                               void* out, int B, int T, int KV, int G, int d, int NP,
                               int ps, int P, float scale, int window, int dtype_code,
                               void* stream) {
  if (B <= 0 || KV <= 0 || T <= 0 || G <= 0 || d <= 0) return 0;
  if (NP <= 0 || ps <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cp = static_cast<const int*>(cpos);
  const int* tb = static_cast<const int*>(table);
  const int* p0 = static_cast<const int*>(pos0);
  if (dtype_code == 0)
    return (int)launch<float>(q, k, v, cp, tb, p0, out, B, T, KV, G, d, ps, P, scale,
                              window, s);
  if (dtype_code == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, cp, tb, p0, out, B, T, KV, G, d, ps, P,
                                      scale, window, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block needs for R query rows per
// (slot, kv head) (0 when above the limit), so the caller can reject a head
// width before launching.
extern "C" int paged_attention_smem(int R, int d) {
  const size_t smem = smem_floats(R, d) * sizeof(float);
  return smem > (size_t)kMaxSmem ? 0 : (int)smem;
}
