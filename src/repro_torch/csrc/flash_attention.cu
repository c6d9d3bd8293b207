// Blocked causal flash attention over a full sequence, GQA and a sliding
// window, masked by token positions:
//   out[b, i, h] = sum_j softmax_j(q[b,i,h] . k[b,j,h/G] * scale) v[b,j,h/G]
// over the keys j with pos[b,j] <= pos[b,i] (causal) and, for window > 0,
// pos[b,i] - pos[b,j] < window, and with the same two rules on the indices
// i and j; scale = d^-0.5. Where positions rise by at least one per index
// (arange plus an offset, all the forward passes) the index rules follow from
// the position rules. q (B, S, H, d), k and v
// (B, S, KV, d), pos (B, S) int32, out like q, G = H / KV; all of one dtype
// (float32 or bfloat16). A row with no visible key gives zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel), whose grid (batch, q head, q block,
// kv block) carries the running softmax in scratch along the sequential kv
// axis and skips the compute of kv blocks outside the window (their copies
// still run). Here a loop inside the block replaces that axis.
//
// Bound: operations. 4*d flops per visible (query, key) pair and head: at
// mistral-7b (S 8192, window 4096, 32 heads) 412 GFLOP a layer, 0.42 ms at
// 989 TFLOP/s, against 0.05 ms for the 168 MB of q, k, v and out.
//
// Design: one block of 128 threads per (batch, kv head, tile of Tq query
// positions), Tq = 64 / G (at least 1): the block's 64 rows are the G query
// heads of those positions, so each K/V tile is loaded once for all G heads
// that read it. The block walks keys in tiles of 64 from max(0, q0 - window +
// 1) to the last query's own index (causal), or to S: tiles wholly outside
// the window or in the future are never read. That skip is by index, so the
// mask applies the rules to indices as well as to positions (as the plain
// version does), and the skipped tiles hold no visible key whatever the
// positions; the index rule is evaluated only in the tiles where it can
// fail. Keys past S are zero rows, masked. Each warp owns 16 of the 64 rows:
// their scores, running max, running sum and accumulator never leave the
// warp, so only the K/V tile loads need the whole block. The running max
// starts at -2^30 (NEG_INF of the Pallas kernel) and masked probabilities
// are 0, so a row that sees no key ends with l = 0 and writes 0 / max(l,
// 1e-30) = 0, the guard of the JAX blocked core. Loads and stores are 16
// bytes a thread.
// bfloat16: scores and the value mix run on the tensor cores through WMMA
// 16x16x16 fragments (mma.sync) with fp32 accumulators; each warp keeps its
// Q fragments in registers for the whole key loop; scores go through shared
// memory for the fp32 softmax, the probabilities are rounded to bf16 for the
// value mix, and the fp32 accumulator lives in shared memory, rescaled there
// by each tile's correction. float32: plain FMA with the accumulator in
// registers (no TF32), key rows padded by one float so lanes reading
// different keys hit different banks. A later PR can pipeline the K/V loads
// and keep the bf16 accumulator in registers (wgmma); this is the simple form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kRows = 64;   // query rows (positions x heads) per block
constexpr int kBk = 64;     // keys per tile
constexpr int kRowsPerWarp = 16;
constexpr float kNegInf = -1073741824.0f;  // -2^30, NEG_INF of the Pallas kernel
constexpr int kMaxSmem = 232448;           // 227 KB per block on sm_90

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  int S, H, KV, G, Tq, causal, window;
  float scale;
};

// the rule for a query at position (or index) pq and a key at pk
__device__ __forceinline__ bool visible(int pq, int pk, int causal, int window) {
  return (!causal || pk <= pq) && (window <= 0 || pq - pk < window);
}

// whether the rule on indices can fail in the key tile at j0: only in a tile
// that reaches past the block's first query or starts before its last
// query's window; elsewhere it holds for every row and is not evaluated
__device__ __forceinline__ bool tile_needs_index_rule(int j0, int q0, int q_last, int causal,
                                                      int window) {
  return (causal && j0 + kBk - 1 > q0) || (window > 0 && j0 < q_last - window + 1);
}

// shared-memory layout of the bf16 kernel, in bytes (every region 32-byte aligned)
template <int D>
struct Bf16Smem {
  static constexpr int kLdQ = D + 8;     // bf16 rows of Q, K, V
  static constexpr int kLdS = kBk + 4;   // fp32 scores
  static constexpr int kLdP = kBk + 8;   // bf16 probabilities
  static constexpr int kLdO = D + 4;     // fp32 accumulator
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kLdQ * 2;
  static constexpr int kV = kK + kBk * kLdQ * 2;
  static constexpr int kS = kV + kBk * kLdQ * 2;
  static constexpr int kP = kS + kRows * kLdS * 4;
  static constexpr int kO = kP + kRows * kLdP * 2;
  static constexpr int kM = kO + kRows * kLdO * 4;
  static constexpr int kL = kM + kRows * 4;
  static constexpr int kPq = kL + kRows * 4;
  static constexpr int kPk = kPq + kRows * 4;
  static constexpr int kBytes = kPk + kBk * 4;
};

// shared-memory layout of the fp32 kernel, in bytes
template <int D>
struct F32Smem {
  static constexpr int kLdK = D + 1;     // padded key rows
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * D * 4;
  static constexpr int kV = kK + kBk * kLdK * 4;
  static constexpr int kP = kV + kBk * D * 4;
  static constexpr int kPq = kP + kRows * kBk * 4;
  static constexpr int kPk = kPq + kRows * 4;
  static constexpr int kBytes = kPk + kBk * 4;
};

// the block's key range [lo, hi) by index
__device__ __forceinline__ void key_range(const Args& a, int q0, int& lo, int& hi) {
  const int q_last = min(a.S, q0 + a.Tq) - 1;
  lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  hi = a.causal ? q_last + 1 : a.S;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bf16(Args a) {
  using L = Bf16Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::kP);
  float* sO = reinterpret_cast<float*>(smem + L::kO);
  float* sM = reinterpret_cast<float*>(smem + L::kM);
  float* sL = reinterpret_cast<float*>(smem + L::kL);
  int* sPq = reinterpret_cast<int*>(smem + L::kPq);
  int* sPk = reinterpret_cast<int*>(smem + L::kPk);

  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(a.v);
  bf16* __restrict__ out = static_cast<bf16*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * a.Tq, kvh = blockIdx.y, b = blockIdx.z;
  const int R = a.Tq * a.G, H = a.H, S = a.S;
  constexpr int kVec = D / 8;   // 16-byte vectors per row

  for (int e = tid; e < kRows * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    const int t = r / a.G, i = q0 + t;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < R && i < S)
      val = *reinterpret_cast<const uint4*>(
          q + (((long long)b * S + i) * H + kvh * a.G + r % a.G) * D + c);
    *reinterpret_cast<uint4*>(sQ + r * L::kLdQ + c) = val;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const int i = q0 + r / a.G;
    sPq[r] = (r < R && i < S) ? a.pos[(long long)b * S + i] : 0;
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  for (int e = tid; e < kRows * L::kLdO; e += kThreads) sO[e] = 0.f;
  __syncthreads();

  const int r0 = warp * kRowsPerWarp;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], sQ + r0 * L::kLdQ + kk * 16, L::kLdQ);

  int lo, hi;
  key_range(a, q0, lo, hi);
  const int q_last = min(S, q0 + a.Tq) - 1;
  for (int j0 = lo; j0 < hi; j0 += kBk) {
    const bool by_index = tile_needs_index_rule(j0, q0, q_last, a.causal, a.window);
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int e = tid; e < kBk * kVec; e += kThreads) {
      const int jj = e / kVec, c = (e % kVec) * 8, j = j0 + jj;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (j < S) {
        const long long off = (((long long)b * S + j) * a.KV + kvh) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + jj * L::kLdQ + c) = kv;
      *reinterpret_cast<uint4*>(sV + jj * L::kLdQ + c) = vv;
    }
    for (int jj = tid; jj < kBk; jj += kThreads)
      sPk[jj] = j0 + jj < S ? a.pos[(long long)b * S + j0 + jj] : 0;
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys
#pragma unroll
    for (int f = 0; f < kBk / 16; ++f) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fs;
      wmma::fill_fragment(fs, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, sK + (f * 16) * L::kLdQ + kk * 16, L::kLdQ);
        wmma::mma_sync(fs, fq[kk], fk, fs);
      }
      wmma::store_matrix_sync(sS + r0 * L::kLdS + f * 16, fs, L::kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time, two keys a lane
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = r0 + rr;
      const bool row_ok = r < R && q0 + r / a.G < S;
      const int pq = sPq[r];
      float s[2];
      bool ok[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jj = lane + 32 * u;
        ok[u] = row_ok && j0 + jj < S && visible(pq, sPk[jj], a.causal, a.window) &&
                (!by_index || visible(q0 + r / a.G, j0 + jj, a.causal, a.window));
        s[u] = ok[u] ? sS[r * L::kLdS + jj] * a.scale : kNegInf;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = ok[u] ? expf(s[u] - m_new) : 0.f;
        sum += p;
        sP[r * L::kLdP + lane + 32 * u] = __float2bfloat16(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m_prev - m_new);
      for (int c = lane; c < D; c += 32) sO[r * L::kLdO + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncwarp();

    // accumulator += P V for this warp's rows
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp[kBk / 16];
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
      wmma::load_matrix_sync(fp[kk], sP + r0 * L::kLdP + kk * 16, L::kLdP);
#pragma unroll
    for (int f = 0; f < D / 16; ++f) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo;
      wmma::load_matrix_sync(fo, sO + r0 * L::kLdO + f * 16, L::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, sV + (kk * 16) * L::kLdQ + f * 16, L::kLdQ);
        wmma::mma_sync(fo, fp[kk], fv, fo);
      }
      wmma::store_matrix_sync(sO + r0 * L::kLdO + f * 16, fo, L::kLdO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();

  // out = acc / max(l, 1e-30), 8 bf16 a lane per store
  for (int e = lane; e < kRowsPerWarp * kVec; e += 32) {
    const int r = r0 + e / kVec, c = (e % kVec) * 8;
    const int t = r / a.G, i = q0 + t;
    if (r >= R || i >= S) continue;
    const float inv_l = 1.f / fmaxf(sL[r], 1e-30f);
    __align__(16) bf16 o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) o[u] = __float2bfloat16(sO[r * L::kLdO + c + u] * inv_l);
    *reinterpret_cast<uint4*>(out + (((long long)b * S + i) * H + kvh * a.G + r % a.G) * D +
                              c) = *reinterpret_cast<const uint4*>(o);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_f32(Args a) {
  using L = F32Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sP = reinterpret_cast<float*>(smem + L::kP);
  int* sPq = reinterpret_cast<int*>(smem + L::kPq);
  int* sPk = reinterpret_cast<int*>(smem + L::kPk);

  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  float* __restrict__ out = static_cast<float*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * a.Tq, kvh = blockIdx.y, b = blockIdx.z;
  const int R = a.Tq * a.G, H = a.H, S = a.S;
  constexpr int kVec = D / 4;              // 16-byte vectors per row
  constexpr int kCols = (D + 31) / 32;     // accumulator columns a lane owns

  for (int e = tid; e < kRows * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 4;
    const int i = q0 + r / a.G;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R && i < S)
      val = *reinterpret_cast<const float4*>(
          q + (((long long)b * S + i) * H + kvh * a.G + r % a.G) * D + c);
    *reinterpret_cast<float4*>(sQ + r * D + c) = val;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const int i = q0 + r / a.G;
    sPq[r] = (r < R && i < S) ? a.pos[(long long)b * S + i] : 0;
  }

  const int r0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[rr][u] = 0.f;
  }

  int lo, hi;
  key_range(a, q0, lo, hi);
  const int q_last = min(S, q0 + a.Tq) - 1;
  for (int j0 = lo; j0 < hi; j0 += kBk) {
    const bool by_index = tile_needs_index_rule(j0, q0, q_last, a.causal, a.window);
    __syncthreads();  // Q is in place; the previous tile's K/V are no longer read
    for (int e = tid; e < kBk * kVec; e += kThreads) {
      const int jj = e / kVec, c = (e % kVec) * 4, j = j0 + jj;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < S) {
        const long long off = (((long long)b * S + j) * a.KV + kvh) * D + c;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      float* kr = sK + jj * L::kLdK + c;
      kr[0] = kv.x; kr[1] = kv.y; kr[2] = kv.z; kr[3] = kv.w;
      *reinterpret_cast<float4*>(sV + jj * D + c) = vv;
    }
    for (int jj = tid; jj < kBk; jj += kThreads)
      sPk[jj] = j0 + jj < S ? a.pos[(long long)b * S + j0 + jj] : 0;
    __syncthreads();

    // scores: lane owns keys lane and lane + 32 of the warp's 16 rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr][0] = s[rr][1] = 0.f;
    for (int c = 0; c < D; c += 4) {
      const float* k0 = sK + lane * L::kLdK + c;
      const float* k1 = sK + (lane + 32) * L::kLdK + c;
      const float ka[4] = {k0[0], k0[1], k0[2], k0[3]};
      const float kb[4] = {k1[0], k1[1], k1[2], k1[3]};
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (r0 + rr) * D + c);
        s[rr][0] = fmaf(qv.x, ka[0], fmaf(qv.y, ka[1], fmaf(qv.z, ka[2], fmaf(qv.w, ka[3], s[rr][0]))));
        s[rr][1] = fmaf(qv.x, kb[0], fmaf(qv.y, kb[1], fmaf(qv.z, kb[2], fmaf(qv.w, kb[3], s[rr][1]))));
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = r0 + rr;
      const bool row_ok = r < R && q0 + r / a.G < S;
      const int pq = sPq[r];
      bool ok[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jj = lane + 32 * u;
        ok[u] = row_ok && j0 + jj < S && visible(pq, sPk[jj], a.causal, a.window) &&
                (!by_index || visible(q0 + r / a.G, j0 + jj, a.causal, a.window));
        s[rr][u] = ok[u] ? s[rr][u] * a.scale : kNegInf;
      }
      float mx = fmaxf(s[rr][0], s[rr][1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[rr], mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = ok[u] ? expf(s[rr][u] - m_new) : 0.f;
        sum += p;
        sP[r * kBk + lane + 32 * u] = p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + sum;
      m[rr] = m_new;
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[rr][u] *= corr;
    }
    __syncwarp();

    // accumulator += P V: lane owns columns lane + 32 u
    for (int jj = 0; jj < kBk; ++jj) {
      float vv[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = lane + 32 * u;
        vv[u] = c < D ? sV[jj * D + c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float p = sP[(r0 + rr) * kBk + jj];
#pragma unroll
        for (int u = 0; u < kCols; ++u) acc[rr][u] = fmaf(p, vv[u], acc[rr][u]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = r0 + rr;
    const int i = q0 + r / a.G;
    if (r >= R || i >= S) continue;
    const float lr = fmaxf(l[rr], 1e-30f);
    float* o = out + (((long long)b * S + i) * H + kvh * a.G + r % a.G) * D;
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = lane + 32 * u;
      if (c < D) o[c] = acc[rr][u] / lr;
    }
  }
}

template <typename Kern>
cudaError_t launch(Kern kern, int smem, const Args& a, int B, cudaStream_t stream) {
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.S + a.Tq - 1) / a.Tq, a.KV, B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const Args& a, int B, int dtype_code, cudaStream_t s) {
  if (dtype_code == 0) return launch(flash_f32<D>, F32Smem<D>::kBytes, a, B, s);
  return launch(flash_bf16<D>, Bf16Smem<D>::kBytes, a, B, s);
}

}  // namespace

// q (B, S, H, d), k and v (B, S, KV, d), pos (B, S) int32, out (B, S, H, d);
// d in {16, 32, 64, 128}; H a multiple of KV with G = H / KV <= 64;
// dtype_code 0 = float32, 1 = bfloat16 (q, k, v and out).
extern "C" int flash_attention(const void* q, const void* k, const void* v, const void* pos,
                               void* out, int B, int S, int H, int KV, int d, int causal,
                               int window, float scale, int dtype_code, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV || H / KV > kRows || (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.Tq = kRows / a.G;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)dispatch<16>(a, B, dtype_code, s);
    case 32: return (int)dispatch<32>(a, B, dtype_code, s);
    case 64: return (int)dispatch<64>(a, B, dtype_code, s);
    case 128: return (int)dispatch<128>(a, B, dtype_code, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
