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
// Design: one block per (batch, kv head, tile of Tq query positions); the
// block's rows are the G query heads of those positions, so each K/V tile
// is loaded once for all G heads that read it: Tq = 128 / G in bf16 (128
// rows, 8 warps of 16; 64 rows at d 256, below), Tq = 64 / G in fp32 (64
// rows, 4 warps), at least 1.
// The block walks keys in tiles of 64 from max(0, q0 - window + 1) to the
// last query's own index (causal), or to S: tiles wholly outside the window
// or in the future are never read. That skip is by index, so the mask
// applies the rules to indices as well as to positions (as the plain
// version does), and the skipped tiles hold no visible key whatever the
// positions; the index rule is evaluated only in the tiles where it can
// fail. Keys past S are zero rows, masked. Each warp owns 16 rows: their
// scores, running max, running sum and accumulator never leave the warp, so
// only the K/V tile loads need the whole block. The running max starts at
// -2^30 (NEG_INF of the Pallas kernel) and masked probabilities are 0, so a
// row that sees no key ends with l = 0 and writes 0 / max(l, 1e-30) = 0, the
// guard of the JAX blocked core.
// bfloat16 (flash_bf16): scores and the value mix run on the tensor cores
// through mma.sync.m16n8k16 in PTX (bf16 A and B, fp32 accumulators) with the
// documented fragment layouts, so nothing goes through shared memory but the
// K/V tiles: each warp keeps its Q fragments (loaded once by ldmatrix), its S
// fragments, its running max and sum and its O accumulator in registers for
// the whole key loop; the softmax runs on the S fragments with quad shuffles,
// in base 2 (scores times scale * log2 e, exp2f: one instruction where expf
// takes several); P is rounded to bf16 straight from the S fragments into A
// fragments; the rescale by each tile's correction multiplies the O registers
// (skipped by a warp whose maxima all held: a product by 1 changes nothing). A
// warp builds no mask for a tile whose keys are all visible to all its rows
// (the tile's positions against its rows', and no index rule there): the
// scores of most tiles, which the mask would leave as they are, cost no
// compare. K fragments come by ldmatrix, V fragments by ldmatrix.trans, from
// rows padded by 16 bytes (no bank conflicts). The K/V tiles (and their
// positions) come by cp.async into a ring of kStages buffers, one commit group
// a tile, waited on with cp.async.wait_group, so the copies of the next tiles
// are in flight while the math runs on this one. Blocks start with the last
// query tile, whose causal range is the longest, so the short ones fill in at
// the end. Head width 256 (gemma3-1b; Bf16Tile): a warp owning 16 rows with
// all 256 value columns would hold 128 fp32 accumulator and 64 Q-fragment
// registers a lane before S and P, and spill; and three stages of 64-key
// K/V tiles (203 KB) beside 128 query rows (66 KB) exceed the 227 KB a block
// may have. So at d 256 two warps share 16 rows, each computing their whole
// S and softmax (the same instructions on the same data) and owning 128 of
// the value columns; a block holds 64 rows (8 warps), and the ring 2 stages:
// the copy of tile i + 1 still overlaps the math of tile i (165 KB a
// block).
// float32 (flash_f32): plain FMA with the accumulator in registers (no
// TF32), key rows padded by one float so lanes reading different keys hit
// different banks; loads and stores are 16 bytes a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // fp32 kernel
constexpr int kRows = 64;      // query rows (positions x heads) per block, fp32
constexpr int kThreadsBf16 = 256;
constexpr int kBk = 64;         // keys per tile
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

// the bf16 kernel's tiles by head width (see Design): warps sharing 16
// rows (each owning kCols value columns), rows a block, K/V tiles in flight
template <int D>
struct Bf16Tile {
  static constexpr int kColWarps = D > 128 ? 2 : 1;
  static constexpr int kCols = D / kColWarps;
  static constexpr int kRows = kThreadsBf16 / 32 * 16 / kColWarps;  // 128; 64 at d 256
  static constexpr int kStages = D > 128 ? 2 : 3;
  static_assert(kCols % 16 == 0, "a warp's value columns in 16-wide ldmatrix steps");
};

// shared-memory layout of the bf16 kernel, in bytes: the Q rows (read once
// into registers), then kStages buffers of (K tile, V tile, key positions)
template <int D>
struct Bf16Smem {
  static constexpr int kLd = D + 8;  // bf16 per row: 16 bytes of padding
  static constexpr int kQ = 0;
  static constexpr int kStage = 2 * kBk * kLd * 2 + kBk * 4;
  static constexpr int kBuf = kQ + Bf16Tile<D>::kRows * kLd * 2;
  static constexpr int kBytes = kBuf + Bf16Tile<D>::kStages * kStage;
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
__global__ void __launch_bounds__(kThreadsBf16, 1) flash_bf16(Args a) {
  using L = Bf16Smem<D>;
  using W = Bf16Tile<D>;
  constexpr int kStages = W::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);

  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(a.v);
  bf16* __restrict__ out = static_cast<bf16*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the last query tile first: its causal key range is the longest
  const int q0 = (gridDim.x - 1 - blockIdx.x) * a.Tq, kvh = blockIdx.y, b = blockIdx.z;
  const int R = a.Tq * a.G, H = a.H, S = a.S;
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  const int* __restrict__ pos = a.pos + (long long)b * S;

  int lo, hi;
  key_range(a, q0, lo, hi);
  const int q_last = min(S, q0 + a.Tq) - 1;
  const int n_tiles = (hi - lo + kBk - 1) / kBk;

  // K/V tile `it` (keys lo + it * kBk ...) into ring buffer it % kStages
  auto copy_tile = [&](int it) {
    unsigned char* buf = smem + L::kBuf + (it % kStages) * L::kStage;
    bf16* sK = reinterpret_cast<bf16*>(buf);
    bf16* sV = sK + kBk * L::kLd;
    int* sPk = reinterpret_cast<int*>(sV + kBk * L::kLd);
    const int j0 = lo + it * kBk;
    for (int e = tid; e < kBk * kVec; e += kThreadsBf16) {
      const int jj = e / kVec, c = (e % kVec) * 8, j = j0 + jj;
      const bool ok = j < S;
      const long long off = ok ? (((long long)b * S + j) * a.KV + kvh) * D + c : 0;
      cp_async16(sK + jj * L::kLd + c, k + off, ok);
      cp_async16(sV + jj * L::kLd + c, v + off, ok);
    }
    for (int jj = tid; jj < kBk; jj += kThreadsBf16)
      cp_async4(sPk + jj, pos + (j0 + jj < S ? j0 + jj : 0), j0 + jj < S);
  };

  // Q rows (zeros past R or S), with tile 0 as commit group 0; tile 1 group 1
  for (int e = tid; e < W::kRows * kVec; e += kThreadsBf16) {
    const int r = e / kVec, c = (e % kVec) * 8, i = q0 + r / a.G;
    const bool ok = r < R && i < S;
    const long long off = ok ? (((long long)b * S + i) * H + kvh * a.G + r % a.G) * D + c : 0;
    cp_async16(sQ + r * L::kLd + c, q + off, ok);
  }
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_tiles) copy_tile(it);
    cp_async_commit();
  }

  // this warp's 16 rows from r0: lane holds rows g and g + 8, columns 2 tq,
  // 2 tq + 1; its value columns start at c0
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp / W::kColWarps * kRowsPerWarp, c0 = warp % W::kColWarps * W::kCols;
  int rr[2], qi[2], pq[2];
  bool rok[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    rr[u] = r0 + g + 8 * u;
    qi[u] = q0 + rr[u] / a.G;
    rok[u] = rr[u] < R && qi[u] < S;
    pq[u] = rok[u] ? pos[qi[u]] : 0;
  }

  // the range of this warp's row positions, for the tiles that need no mask
  int pq_lo = rok[0] ? pq[0] : INT_MAX, pq_hi = rok[0] ? pq[0] : INT_MIN;
  if (rok[1]) pq_lo = min(pq_lo, pq[1]), pq_hi = max(pq_hi, pq[1]);
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1) {
    pq_lo = min(pq_lo, __shfl_xor_sync(0xffffffffu, pq_lo, o2));
    pq_hi = max(pq_hi, __shfl_xor_sync(0xffffffffu, pq_hi, o2));
  }
  const float scale2 = a.scale * 1.4426950408889634f;  // scale * log2 e

  cp_async_wait<kStages - 2>();
  __syncthreads();  // Q is in shared memory
  constexpr int kK = D / 16;  // k-steps of S = Q K^T
  unsigned aq[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
    ldsm_x4(aq[kk], sQ + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kLd + kk * 16 +
                        (lane >> 4) * 8);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[W::kCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < W::kCols / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it has landed; tile it - 1's buffer is free
    if (it + kStages - 1 < n_tiles) copy_tile(it + kStages - 1);
    cp_async_commit();

    const int j0 = lo + it * kBk;
    const unsigned char* buf = smem + L::kBuf + (it % kStages) * L::kStage;
    const bf16* sK = reinterpret_cast<const bf16*>(buf);
    const bf16* sV = sK + kBk * L::kLd;
    const int* sPk = reinterpret_cast<const int*>(sV + kBk * L::kLd);
    const bool by_index = tile_needs_index_rule(j0, q0, q_last, a.causal, a.window);

    // S = Q K^T for this warp's 16 rows against the 64 keys
    float sc[kBk / 8][4];
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < kBk / 16; ++j2) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        unsigned bk[4];
        ldsm_x4(bk, sK + (j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * L::kLd + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(sc[2 * j2], aq[kk], bk[0], bk[1]);
        mma(sc[2 * j2 + 1], aq[kk], bk[2], bk[3]);
      }
    }

    // whether every key of the tile is visible to every row of this warp,
    // by position (its rows' positions against the tile's range) and by
    // index (by_index false): then the tile's scores need no mask
    int pk_lo = min(sPk[lane], sPk[lane + 32]), pk_hi = max(sPk[lane], sPk[lane + 32]);
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) {
      pk_lo = min(pk_lo, __shfl_xor_sync(0xffffffffu, pk_lo, o2));
      pk_hi = max(pk_hi, __shfl_xor_sync(0xffffffffu, pk_hi, o2));
    }
    const bool open = !by_index && j0 + kBk <= S && pq_lo <= pq_hi &&
                      (!a.causal || pk_hi <= pq_lo) && (a.window <= 0 || pq_hi - pk_lo < a.window);

    // online softmax on the fragments, in base 2 (scores times scale *
    // log2 e): element e of n-tile j is row g + 8 (e >> 1), key
    // 8 j + 2 tq + (e & 1)
    unsigned okbits = ~0u;
    float mx[2] = {kNegInf, kNegInf};
    if (open) {
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= scale2;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      }
    } else {
      okbits = 0;
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1, jj = 8 * j + 2 * tq + (e & 1), jk = j0 + jj;
          const bool ok = rok[u] && jk < S && visible(pq[u], sPk[jj], a.causal, a.window) &&
                          (!by_index || visible(qi[u], jk, a.causal, a.window));
          okbits |= (ok ? 1u : 0u) << (4 * j + e);
          sc[j][e] = ok ? sc[j][e] * scale2 : kNegInf;
          mx[u] = fmaxf(mx[u], sc[j][e]);
        }
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      const float m_new = fmaxf(m[u], mx[u]);
      corr[u] = exp2f(m[u] - m_new);
      m[u] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (okbits >> (4 * j + e)) & 1u ? exp2f(sc[j][e] - m[e >> 1]) : 0.f;
        sc[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 1);
      sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 2);
      l[u] = l[u] * corr[u] + sum[u];
    }
    // rescale the accumulator registers (a product by 1 changes nothing,
    // so a warp whose maxima all held skips it)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int nt = 0; nt < W::kCols / 8; ++nt) {
        o[nt][0] *= corr[0];
        o[nt][1] *= corr[0];
        o[nt][2] *= corr[1];
        o[nt][3] *= corr[1];
      }
    }

    // O += P V: P (bf16) from the S fragments, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const unsigned ap[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < W::kCols / 16; ++n2) {
        unsigned bv[4];
        ldsm_x4_t(bv, sV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::kLd + c0 +
                          n2 * 16 + (lane >> 4) * 8);
        mma(o[2 * n2], ap, bv[0], bv[1]);
        mma(o[2 * n2 + 1], ap, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // out = acc / max(l, 1e-30), two bf16 a store
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!rok[u]) continue;
    const float inv_l = 1.f / fmaxf(l[u], 1e-30f);
    bf16* orow =
        out + (((long long)b * S + qi[u]) * H + kvh * a.G + rr[u] % a.G) * D + c0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < W::kCols / 8; ++nt)
      *reinterpret_cast<unsigned*>(orow + nt * 8) =
          pack_bf16(o[nt][2 * u] * inv_l, o[nt][2 * u + 1] * inv_l);
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
cudaError_t launch(Kern kern, int threads, int rows, int smem, Args a, int B,
                   cudaStream_t stream) {
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  a.Tq = rows / a.G;
  dim3 grid((a.S + a.Tq - 1) / a.Tq, a.KV, B);
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const Args& a, int B, int dtype_code, cudaStream_t s) {
  if (dtype_code == 0) return launch(flash_f32<D>, kThreads, kRows, F32Smem<D>::kBytes, a, B, s);
  return launch(flash_bf16<D>, kThreadsBf16, Bf16Tile<D>::kRows, Bf16Smem<D>::kBytes, a, B,
                s);
}

}  // namespace

// q (B, S, H, d), k and v (B, S, KV, d), pos (B, S) int32, out (B, S, H, d);
// d in {16, 32, 64, 128, 256}; H a multiple of KV with G = H / KV <= 64;
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
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)dispatch<16>(a, B, dtype_code, s);
    case 32: return (int)dispatch<32>(a, B, dtype_code, s);
    case 64: return (int)dispatch<64>(a, B, dtype_code, s);
    case 128: return (int)dispatch<128>(a, B, dtype_code, s);
    case 256: return (int)dispatch<256>(a, B, dtype_code, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
