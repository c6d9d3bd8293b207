// In-place paged attention of a whole query chunk, in three forms.
//
// Dense (GQA) form:
//   out[b, t, h, g, :] = softmax_j(q[b,t,h,g]·k_j * scale) · v_j
// MLA form (DeepSeek-V2 latent attention, absorbed; one latent "kv head"):
//   out[b, t, 0, h, :] = softmax_j((q_abs·ckv_j + q_pe·kpe_j) * scale) · ckv_j
// with q rows [q_abs (r) | q_pe (dr)], ckv pages (NP, ps, 1, r) and kpe pages
// (NP, ps, 1, dr); the value mix re-reads the ckv rows (MLA caches no V).
// int8 form (the int8 KV cache): int8 k / v pages with bf16 scales
// (NP, ps, KV), one per (token, kv head):
//   p_j = softmax_j((q·k_j) * ks_j * scale),
//   out = sum_j (p_j * vs_j) · v_j
// where the running sum l takes p_j before vs_j multiplies it.
// Keys j are the slot's pages read through the page table (page
// table[b, j / ps], row j % ps); a key is valid iff its stored position c
// satisfies c >= 0, c <= pos0[b] + t and, with a window, pos0[b] + t - c <
// window. Rows with no valid key come out as zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention / _paged_kernel; the MLA form is its `mla_split` variant,
// the int8 form its `quant` variant). There the grid is (slot, kv head,
// page) and the running softmax lives in scratch carried along the
// sequential page axis.
//
// Bound: bytes at serving shapes. Each (slot, kv head) reads its keys and
// values once, while the query rows (4 at a mistral-7b decode step, 16 for an
// MLA step: one per head) give only a few flops per element read, far below
// the card's ratio of compute to bandwidth. The int8 form reads one byte per
// K/V element plus two bytes of scale per (token, kv head).
//
// Design of the template below (the dense form with fp32 pages, mixed
// dtypes or other widths, the MLA form other than fp32 q over bf16 pages,
// and the int8 form other than bf16 q at d % 16 == 0, d <= 128 or d = 256;
// the dense form with bf16 q and pages at those widths, the int8 form with
// bf16 q at the same widths and the MLA form with fp32 q over bf16 pages at
// r % 16 == 0, dr % 16 == 0, r, dr <= 512 have their own kernels,
// namespaces split and mla_split further down): the T*G query rows of one
// (slot, kv head) are split into tiles of at most kRowTile = 64 rows
// (kRowTileMla = 16 in the MLA form, whose 576-wide query rows and 512-wide
// accumulators would not fit 64 rows in shared memory), one block per
// (slot, kv head, row tile), so any chunk length and group size fit and the
// grid grows with the chunk. Each block keeps its rows
// in shared memory and walks the slot's virtual cache in tiles of 32 keys;
// that loop replaces the TPU's sequential grid axis. Every block reads the
// slot's keys for its own rows (from L2 after the first). A tile's keys are
// addressed row by row through the table, so any page size works the same
// (including the page size of 1 that an odd ring length forces on the dense
// view) and no gathered copy of the cache is ever made. A tile whose 32
// stored positions are all unusable for every query row (empty ring slots,
// beyond the chunk, outside the window) is skipped before its keys are read;
// a skipped tile would change no row's running state, so the split into row
// tiles leaves every row's result bit for bit as with one block. Scores, the
// running max, the running sum and the accumulator are fp32, whatever the
// types of q (and the output) and of the pages: the MLA form takes fp32
// queries (W_UK absorbed in fp32) over bf16 pages, the int8 form bf16 or
// fp32 queries over int8 pages, widened to fp32 in shared memory as the
// dense form widens bf16; a tile's 32 key and value scales sit beside its
// stored positions (zero for invalid keys). The softmax is one warp
// per query row with shuffle reductions. The running max starts at NEG_INF =
// -2^30 and invalid probabilities are forced to 0, as in the Pallas kernel,
// so a row with no valid key ends with l = 0 and writes 0 / max(l, 1e-30) =
// 0; key rows of invalid entries are zero in shared memory, so the MLA value
// mix (which reads the key tile) never multiplies 0 by garbage. Key rows are
// padded by one float in shared memory so the score loop (lanes on different
// keys) is free of bank conflicts. The shared footprint (about 105 KB for a
// 64-row tile at d = 128; about 146 KB for a 16-row MLA tile at r = 512,
// dr = 64; 256 bytes more for the int8 form's scales) is above the 48 KB
// static limit, so it is dynamic shared memory opted in with
// cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // keys per tile = one warp lane per key in the softmax
constexpr int kRowTile = 64;     // query rows per block
constexpr int kRowTileMla = 16;  // query rows per block, MLA form
constexpr float kNegInf = -1073741824.0f;  // -2^30, as NEG_INF in the Pallas kernel
constexpr int kMaxSmem = 232448;           // 227 KB per block on sm_90

// kernel forms; the same codes as paged_attention_smem's `form`
constexpr int kDense = 0, kMla = 1, kQuant = 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool usable(int c, int qp, int window) {
  return c >= 0 && c <= qp && (window == 0 || qp - c < window);
}

size_t smem_floats(int R, int dq, int dv, int form) {
  const bool mla = form == kMla;
  const int tile = mla ? kRowTileMla : kRowTile;
  R = R < tile ? R : tile;          // rows one block holds
  return (size_t)R * (dq + 1)       // q rows
         + (size_t)R * dv           // accumulator
         + (size_t)kTile * (dq + 1)  // key tile (padded); the MLA value tile
         + (mla ? 0 : (size_t)kTile * dv)  // value tile (dense form)
         + (size_t)R * kTile        // scores / probabilities
         + 3 * (size_t)R            // m, l, correction
         + 2 * (size_t)kTile        // stored positions, row addresses (int)
         + (form == kQuant ? 2 * (size_t)kTile : 0);  // key / value scales
}

// MLA: KV == 1, G = heads, dk = r (ckv), dq - dk = dr (kpe, in k2v), dv = r
// and the values are the key tile's first r columns. Dense and int8: dk = dv
// = dq, k2v holds the value pages; int8 also reads the scale pages kscale /
// vscale (NP, ps, KV) bf16 (null in the other forms).
template <typename TQ, typename TK, int FORM>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                       const TK* __restrict__ k2v, const __nv_bfloat16* __restrict__ kscale,
                       const __nv_bfloat16* __restrict__ vscale, const int* __restrict__ cpos,
                       const int* __restrict__ table, const int* __restrict__ pos0,
                       TQ* __restrict__ out, int T_, int KV, int G, int dq, int dk, int dv,
                       int ps, int P, float scale, int window) {
  constexpr bool MLA = FORM == kMla;
  constexpr bool QUANT = FORM == kQuant;
  extern __shared__ float smem[];
  constexpr int tile = MLA ? kRowTileMla : kRowTile;
  const int R = T_ * G;
  const int r0 = blockIdx.y * tile;              // first row of this block
  const int Rb = min(tile, R - r0);              // rows of this block
  const int Rs = min(tile, R);                   // rows the layout holds
  const int ks = dq + 1;                         // key tile row stride
  float* sQ = smem;
  float* sAcc = sQ + Rs * ks;
  float* sK = sAcc + Rs * dv;
  float* sV = MLA ? sK : sK + kTile * ks;
  const int vs = MLA ? ks : dv;                  // value tile row stride
  float* sS = sV + (MLA ? kTile * ks : kTile * dv);
  float* sM = sS + Rs * kTile;
  float* sL = sM + Rs;
  float* sCorr = sL + Rs;
  int* sPos = reinterpret_cast<int*>(sCorr + Rs);
  int* sRow = sPos + kTile;
  float* sKs = reinterpret_cast<float*>(sRow + kTile);  // int8 form only
  float* sVs = sKs + kTile;

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = pos0[b];
  const int S = P * ps;
  const int d2 = dq - dk;                        // MLA: kpe width
  // int8 rows move in 16-byte loads when every row starts 16-byte aligned
  const bool vec16 = QUANT && dq % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k2v) % 16 == 0;
  // the loosest rows of this block: its last lane for causality, its first
  // for the window
  const int t_lo = r0 / G, t_hi = (r0 + Rb - 1) / G;

  for (int i = tid; i < Rb * dq; i += kThreads) {
    const int r = i / dq, c = i % dq;
    const int t = (r0 + r) / G, g = (r0 + r) % G;
    sQ[r * ks + c] = to_f(q[((((long long)b * T_ + t) * KV + h) * G + g) * dq + c]);
  }
  for (int i = tid; i < Rb * dv; i += kThreads) sAcc[i] = 0.f;
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
      if (QUANT) {
        const long long srow = (long long)row * KV + h;
        sKs[tid] = c >= 0 ? __bfloat162float(kscale[srow]) : 0.f;
        sVs[tid] = c >= 0 ? __bfloat162float(vscale[srow]) : 0.f;
      }
      live = c >= 0 && c <= p0 + t_hi && (window == 0 || p0 + t_lo - c < window);
    }
    if (!__syncthreads_or(live)) continue;

    if (MLA) {  // key rows [ckv | kpe]; the values are their ckv part
      for (int i = tid; i < kTile * dq; i += kThreads) {
        const int j = i / dq, c = i % dq;
        float x = 0.f;
        if (sPos[j] >= 0) {
          const long long row = (long long)sRow[j] * KV + h;
          x = c < dk ? to_f(k[row * dk + c]) : to_f(k2v[row * d2 + (c - dk)]);
        }
        sK[j * ks + c] = x;
      }
    } else if (QUANT && vec16) {  // int8 rows: 16 values per 16-byte load
      const int nv = dq / 16;
      for (int i = tid; i < kTile * nv; i += kThreads) {
        const int j = i / nv, c0 = (i % nv) * 16;
        int4 kw = make_int4(0, 0, 0, 0), vw = kw;
        if (sPos[j] >= 0) {
          const long long off = ((long long)sRow[j] * KV + h) * dq + c0;
          kw = *reinterpret_cast<const int4*>(k + off);
          vw = *reinterpret_cast<const int4*>(k2v + off);
        }
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kw);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          sK[j * ks + c0 + e] = (float)kb[e];
          sV[j * dv + c0 + e] = (float)vb[e];
        }
      }
    } else {    // key and value rows of width dq = dv, element by element
      for (int i = tid; i < kTile * dq; i += kThreads) {
        const int j = i / dq, c = i % dq;
        float kv_k = 0.f, kv_v = 0.f;
        if (sPos[j] >= 0) {
          const long long off = ((long long)sRow[j] * KV + h) * dq + c;
          kv_k = to_f(k[off]);
          kv_v = to_f(k2v[off]);
        }
        sK[j * ks + c] = kv_k;
        sV[j * dv + c] = kv_v;
      }
    }
    __syncthreads();

    for (int i = tid; i < Rb * kTile; i += kThreads) {
      const int r = i / kTile, j = i % kTile;
      float s = kNegInf;
      if (usable(sPos[j], p0 + (r0 + r) / G, window)) {
        const float* qr = sQ + r * ks;
        const float* kr = sK + j * ks;
        float dot = 0.f;
        for (int c = 0; c < dq; ++c) dot += qr[c] * kr[c];
        if (QUANT) dot *= sKs[j];      // (q·k)·k_scale, then the scale
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
      // l sums p; the value mix takes p·v_scale (int8 form)
      sS[r * kTile + lane] = QUANT ? p * sVs[lane] : p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sCorr[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < Rb * dv; i += kThreads) {
      const int r = i / dv, c = i % dv;
      const float* pr = sS + r * kTile;
      float pv = 0.f;
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) pv += pr[j] * sV[j * vs + c];
      sAcc[i] = sAcc[i] * sCorr[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < Rb * dv; i += kThreads) {
    const int r = i / dv, c = i % dv;
    const int t = (r0 + r) / G, g = (r0 + r) % G;
    const float l = fmaxf(sL[r], 1e-30f);
    out[((((long long)b * T_ + t) * KV + h) * G + g) * dv + c] = from_f<TQ>(sAcc[i] / l);
  }
}

template <typename TQ, typename TK, int FORM>
cudaError_t launch(const void* q, const void* k, const void* k2v, const void* kscale,
                   const void* vscale, const int* cpos, const int* table, const int* pos0,
                   void* out, int B, int T_, int KV, int G, int dq, int dk, int dv, int ps,
                   int P, float scale, int window, cudaStream_t stream) {
  const size_t smem = smem_floats(T_ * G, dq, dv, FORM) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidConfiguration;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<TQ, TK, FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  constexpr int tile = FORM == kMla ? kRowTileMla : kRowTile;
  const dim3 grid(B * KV, (T_ * G + tile - 1) / tile);
  paged_attention_kernel<TQ, TK, FORM><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), static_cast<const TK*>(k2v),
      static_cast<const __nv_bfloat16*>(kscale), static_cast<const __nv_bfloat16*>(vscale),
      cpos, table, pos0, static_cast<TQ*>(out), T_, KV, G, dq, dk, dv, ps, P, scale, window);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16; q and the output share q_code,
// the pages share kv_code (the int8 form's pages are int8 whatever kv_code).
template <int FORM>
int dispatch(const void* q, const void* k, const void* k2v, const void* kscale,
             const void* vscale, const void* cpos, const void* table, const void* pos0, void* out, int B, int T,
             int KV, int G, int dq, int dk, int dv, int ps, int P, float scale, int window,
             int q_code, int kv_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cp = static_cast<const int*>(cpos);
  const int* tb = static_cast<const int*>(table);
  const int* p0 = static_cast<const int*>(pos0);
#define PA_LAUNCH(TQ, TK)                                                                 \
  return (int)launch<TQ, TK, FORM>(q, k, k2v, kscale, vscale, cp, tb, p0, out, B, T, KV, G,  \
                                   dq, dk, dv, ps, P, scale, window, s)
  if constexpr (FORM == kQuant) {
    if (q_code == 0) PA_LAUNCH(float, int8_t);
    if (q_code == 1) PA_LAUNCH(__nv_bfloat16, int8_t);
  } else {
    if (q_code == 0 && kv_code == 0) PA_LAUNCH(float, float);
    if (q_code == 1 && kv_code == 1) PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    if (q_code == 0 && kv_code == 1) PA_LAUNCH(float, __nv_bfloat16);
    if (q_code == 1 && kv_code == 0) PA_LAUNCH(__nv_bfloat16, float);
  }
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ===================================================================
// Dense form, bf16 queries over bf16 pages, d % 16 == 0 and d <= 128, or d
// = 256 (gemma3-1b): the keys split over chunks of fixed length, on the
// tensor cores.
//
// Bound, as above: bytes. At decode shapes one (slot, kv head) has only
// T*G query rows (4 for mistral-7b at T 1, 16 for glm4-9b), so the template
// above, one block per (slot, kv head, row tile) walking all keys alone,
// keeps 8-32 blocks busy on 132 SMs and waits on its loads. Here:
//
// - Split. The grid is (B*KV, row tiles of Tile<D>::kRows, key chunks).
//   Chunk z holds
//   the virtual-cache indices [z*chunk, (z+1)*chunk) with chunk = kChunk = 64,
//   a constant (chunk_len): the boundaries sit at multiples of kChunk in the
//   virtual index and are never chosen from B, KV, T or the SM count (64
//   measured fastest of 64, 128 and 256 at the engine's shapes:
//   scripts/paged_mutants.py, PERF.md). A block first reads its chunk's table
//   entries and stored positions; if no key is usable by any row of the block
//   it writes an empty partial (m = NEG_INF, l = 0) for its rows and exits.
//   Else it computes, for each of its rows, the partial (m, l, acc) over its
//   chunk: the running max, the sum of exp(s - m) and the un-normalised value
//   mix, all fp32, into a workspace (acc (B*KV, chunks, R, d), then (m, l)
//   (B*KV, chunks, R)).
// - Combine. A second launch (paged_attention_combine_kernel), one warp a
//   query row, takes the chunks in order: m* = max m_s, l = sum l_s e^(m_s -
//   m*), o = sum acc_s e^(m_s - m*) / max(l, 1e-30), cast to bf16. A chunk
//   with l_s = 0 (skipped, or processed without a usable key for the row) adds
//   nothing and its acc is not read: its exact share would be 0 * 0. So a row
//   with no usable key anywhere writes 0. The warp reads the row's (m, l)
//   one chunk a lane, and loads the next live chunk's acc while it adds the
//   current one.
// - Tensor cores. Each warp owns one m16 tile of query rows (rows past R
//   are zero and masked), held as bf16 A fragments in registers for the
//   whole chunk, and the tile's D accumulator columns (Tile<D>). At D 256
//   that would be 128 fp32 accumulator and 64 fragment registers a lane
//   before S and P, past the 255 a thread may hold: there the block's four
//   warps share one m16 tile, each computing the tile's whole S and softmax
//   (the same instructions on the same data, so the same bits) and owning
//   64 of the value columns, and a block holds 16 rows. S = Q K^T runs on
//   mma.sync.m16n8k16 (bf16, fp32 accumulators) with K fragments from
//   shared memory by ldmatrix; the fp32 softmax runs on the S fragments
//   with quad shuffles for the row max and sum; P goes straight from the S
//   fragments into two bf16 A fragments, hi = bf16(P) and lo = bf16(P -
//   hi), and P V runs on mma.sync as hi V + lo V with V fragments by
//   ldmatrix.trans (P to about 16 bits: the value mix as exact as fp32
//   probabilities over bf16 values, for two more tensor-core products a key
//   tile in a kernel bound by its loads); the accumulator stays in
//   registers. All fragment layouts are PTX's documented ones.
// - Loads. The K and V rows of the chunk come in by cp.async, 16 bytes (8
//   bf16) a copy, each key row's address through the table (any page size,
//   down to 1); a key with no stored position (empty ring slot, past the
//   cache) is zero-filled, not read. The chunk's two sub-tiles of 32 keys
//   are started at once, one commit group each, so the math on the first
//   runs while the copies of the second are in flight. Key rows are padded
//   by 16 bytes so ldmatrix is free of bank conflicts.
//
// Bitwise contracts (sharded_paged_attention equals the unsharded call; a
// chunk of T queries equals T one-token calls): every query row's result
// depends only on its own query, its slot's keys and the fixed chunk layout.
// mma.sync computes each output element from its own row of A and column
// of B; the softmax, the partial and the combine of a row read only that
// row's values; the chunk boundaries and the chunk count ceil(P*ps /
// kChunk) do not depend on T, B, KV, the row's place in its m16 tile or the
// grid. Whether a block processes a chunk depends on its other rows, but
// for a row without a usable key there a processed chunk gives m = NEG_INF,
// l = 0 exactly (every probability is forced to 0), the same partial as a
// skipped one, and the combine skips both. Inside a processed chunk every
// sub-tile is processed.
//
// The int8 form with bf16 q (d % 16 == 0, d <= 128 or d = 256; the engines' int8
// attends at full width) runs this kernel with Q = true; only the loads of
// the pages and two scalings differ:
// - Loads. The chunk's int8 K and V rows come in by cp.async, 16 bytes (16
//   values) a copy, into two int8 staging tiles, one commit group per
//   sub-tile as above; a key with no stored position is zero-filled, not
//   read. After a sub-tile's wait the block widens its rows to bf16 into
//   the same padded sK / sV tiles the dense form reads (copy_chunk_int8,
//   widen_sub: values in [-127, 127] are exact in bf16, so nothing is lost)
//   and meets at a second barrier. Each key's k_scale and v_scale go to
//   shared memory as fp32 beside its stored position (0 for a key with no
//   stored position, not read).
// - Scores: s = (q·k_j) * ks_j * scale, in that order, in fp32, on the S
//   fragments (q·k_j from the same bf16 mma.sync products as the dense form).
// - Values: l takes p_j; the value mix takes p_j * vs_j, in fp32, and only
//   then splits into the bf16 hi / lo A fragments. Neither scale is folded
//   into the pages: an int8 value times a bf16 scale needs about 16 bits,
//   so a fold would round it to bf16.
// The partials, their workspace and the combine are the dense form's, with
// the output in bf16. A block takes the dense layout plus 2 x 64 x d bytes
// of staging and 2 x 64 fp32 scales: 52 KB at d 128, four blocks an SM;
// 101 KB at d 256 (the dense form 68 KB), two blocks an SM.
//
// The MLA form runs the same split and combine (namespace mla_split below).
// internal linkage: no function-local static is shared between libraries
namespace {
namespace split {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;         // keys per chunk
constexpr int kSub = 32;            // keys per sub-tile (one commit group)
constexpr int kSubs = kChunk / kSub;
static_assert(kSub % 16 == 0 && kSub / 2 <= 32, "one bit a score of a lane's sub-tile");
static_assert(kChunk % kSub == 0 && kSubs <= 4, "cp_async_wait_upto takes 0-3");

// Warps of a block that share one m16 tile of query rows, each owning
// kCols of the D value columns: 1 up to D 128, 4 at D 256 (see Tensor cores
// above); kRows query rows a block.
template <int D>
struct Tile {
  static constexpr int kColWarps = D > 128 ? 4 : 1;
  static constexpr int kCols = D / kColWarps;
  static constexpr int kRows = 16 * kWarps / kColWarps;
  static_assert(kCols % 16 == 0, "a warp's value columns in 16-wide ldmatrix steps");
};

// The chunk length. A constant: never chosen from B, KV, T (R = T*G rows)
// or the SM count, or the bitwise contracts above break.
int chunk_len(int B, int KV, int R, int S) { return kChunk; }

// Q: the int8 form, whose scales and int8 staging tiles follow the dense
// layout
template <int D, bool Q>
struct Smem {
  static constexpr int kLd = D + 8;  // bf16 per key row, 16 bytes of padding
  static constexpr int kK = 0;
  static constexpr int kV = kK + kChunk * kLd * 2;
  static constexpr int kPos = kV + kChunk * kLd * 2;
  static constexpr int kRow = kPos + kChunk * 4;
  static constexpr int kKs = kRow + kChunk * 4;          // fp32 k_scale a key
  static constexpr int kVs = kKs + (Q ? kChunk * 4 : 0);  // fp32 v_scale a key
  static constexpr int kStK = kVs + (Q ? kChunk * 4 : 0);  // int8 K rows
  static constexpr int kStV = kStK + (Q ? kChunk * D : 0);  // int8 V rows
  static constexpr int kBytes = kStV + (Q ? kChunk * D : 0);
};

// The chunk's K and V rows into shared memory: sub-tile s is commit group s.
template <int D>
__device__ __forceinline__ void copy_chunk(bf16* sK, bf16* sV, const int* sPos, const int* sRow,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v, int KV, int h) {
  constexpr int kVec = D / 8;  // 16-byte copies per row
  constexpr int kLd = Smem<D, false>::kLd;
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    for (int e = threadIdx.x; e < kSub * kVec; e += kThreads) {
      const int jj = s * kSub + e / kVec, c = (e % kVec) * 8;
      const bool ok = sPos[jj] >= 0;
      const long long off = ok ? ((long long)sRow[jj] * KV + h) * D + c : 0;
      cp_async16(sK + jj * kLd + c, k + off, ok);
      cp_async16(sV + jj * kLd + c, v + off, ok);
    }
    cp_async_commit();
  }
}

// The int8 form: the chunk's int8 K and V rows into the staging tiles (D
// bytes a row), sub-tile s commit group s, as copy_chunk.
template <int D>
__device__ __forceinline__ void copy_chunk_int8(int8_t* stK, int8_t* stV, const int* sPos,
                                                 const int* sRow, const int8_t* __restrict__ k,
                                                 const int8_t* __restrict__ v, int KV, int h) {
  constexpr int kVec = D / 16;  // 16-byte copies per row
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    for (int e = threadIdx.x; e < kSub * kVec; e += kThreads) {
      const int jj = s * kSub + e / kVec, c = (e % kVec) * 16;
      const bool ok = sPos[jj] >= 0;
      const long long off = ok ? ((long long)sRow[jj] * KV + h) * D + c : 0;
      cp_async16(stK + jj * D + c, k + off, ok);
      cp_async16(stV + jj * D + c, v + off, ok);
    }
    cp_async_commit();
  }
}

// The int8 form: sub-tile s's staged K and V rows widened to bf16 (exact)
// into the padded tiles that the products read, 16 values a thread-step.
template <int D>
__device__ __forceinline__ void widen_sub(const int8_t* stK, const int8_t* stV, bf16* sK,
                                          bf16* sV, int s) {
  constexpr int kVec = D / 16;  // 16-value groups per row
  constexpr int kLd = Smem<D, true>::kLd;
  for (int e = threadIdx.x; e < 2 * kSub * kVec; e += kThreads) {
    const bool is_v = e >= kSub * kVec;
    const int r = is_v ? e - kSub * kVec : e;
    const int jj = s * kSub + r / kVec, c = (r % kVec) * 16;
    const int4 w = *reinterpret_cast<const int4*>((is_v ? stV : stK) + jj * D + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
    unsigned x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = pack_bf16((float)b[2 * u], (float)b[2 * u + 1]);
    uint4* dst = reinterpret_cast<uint4*>((is_v ? sV : sK) + jj * kLd + c);
    dst[0] = make_uint4(x[0], x[1], x[2], x[3]);
    dst[1] = make_uint4(x[4], x[5], x[6], x[7]);
  }
}

// Q: the int8 form (k, v int8 pages; kscale, vscale their bf16 scales);
// else the dense form (k, v bf16 pages; no scales)
template <int D, bool Q>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const bf16* __restrict__ q, const void* __restrict__ k,
                             const void* __restrict__ v, const bf16* __restrict__ kscale,
                             const bf16* __restrict__ vscale, const int* __restrict__ cpos,
                             const int* __restrict__ table, const int* __restrict__ pos0,
                             float* __restrict__ ws, int T_, int KV, int G, int ps, int P,
                             int chunk, int nch, float scale, int window) {
  using L = Smem<D, Q>;
  using W = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  int* sPos = reinterpret_cast<int*>(smem + L::kPos);
  int* sRow = reinterpret_cast<int*>(smem + L::kRow);
  float* sKs = reinterpret_cast<float*>(smem + L::kKs);  // int8 form only
  float* sVs = reinterpret_cast<float*>(smem + L::kVs);
  int8_t* sStK = reinterpret_cast<int8_t*>(smem + L::kStK);
  int8_t* sStV = reinterpret_cast<int8_t*>(smem + L::kStV);

  const int bh = blockIdx.x, b = bh / KV, h = bh % KV;
  const int R = T_ * G;
  const int rb0 = blockIdx.y * W::kRows, rb1 = min(R, rb0 + W::kRows);  // the block's rows
  const int j0 = blockIdx.z * chunk;
  const int S = P * ps;
  const int n = min(chunk, S - j0);  // keys of this chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = pos0[b];
  // the loosest rows of the block: its last for causality, its first for the window
  const int t_lo = rb0 / G, t_hi = (rb1 - 1) / G;
  const long long part = ((long long)bh * nch + blockIdx.z) * R;  // this partial's row 0
  float* acc_ws = ws + part * D;
  float2* ml_ws = reinterpret_cast<float2*>(ws + (long long)gridDim.x * nch * R * D) + part;

  bool live = false;
  for (int jj = tid; jj < kChunk; jj += kThreads) {
    int c = -1, row = 0;
    if (jj < n) {
      const int j = j0 + jj;
      row = table[(long long)b * P + j / ps] * ps + j % ps;
      c = cpos[row];
    }
    sPos[jj] = c;
    sRow[jj] = row;
    live |= c >= 0 && c <= p0 + t_hi && (window == 0 || p0 + t_lo - c < window);
  }
  if (!__syncthreads_or(live)) {  // an empty partial: no usable key for any row here
    for (int r = rb0 + tid; r < rb1; r += kThreads) ml_ws[r] = make_float2(kNegInf, 0.f);
    return;
  }
  if constexpr (Q) {
    copy_chunk_int8<D>(sStK, sStV, sPos, sRow, static_cast<const int8_t*>(k),
                       static_cast<const int8_t*>(v), KV, h);
    // while the rows fly: each key's scales, 0 for a key with no stored
    // position (not read)
    for (int jj = tid; jj < kChunk; jj += kThreads) {
      const bool ok = sPos[jj] >= 0;
      const long long srow = (long long)sRow[jj] * KV + h;
      sKs[jj] = ok ? __bfloat162float(kscale[srow]) : 0.f;
      sVs[jj] = ok ? __bfloat162float(vscale[srow]) : 0.f;
    }
  } else {
    copy_chunk<D>(sK, sV, sPos, sRow, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  KV, h);
  }

  // this warp's m16 tile: lane holds rows g and g + 8, columns 2 tq, 2 tq + 1;
  // its value columns start at c0
  const int g = lane >> 2, tq = lane & 3;
  const int rw = rb0 + warp / W::kColWarps * 16, c0 = warp % W::kColWarps * W::kCols;
  const bool has_rows = rw < rb1;
  int rr[2], qp[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rr[i] = rw + g + 8 * i;
    rok[i] = rr[i] < rb1;
    qp[i] = p0 + (rok[i] ? rr[i] / G : 0);
  }
  constexpr int kK = D / 16;  // k-steps of S = Q K^T
  unsigned aq[kK][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bf16* qr = q;
    if (rok[i]) {
      const int t = rr[i] / G, gg = rr[i] % G;
      qr = q + ((((long long)b * T_ + t) * KV + h) * G + gg) * D;
    }
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        aq[kk][i + 2 * hf] =
            rok[i] ? *reinterpret_cast<const unsigned*>(qr + kk * 16 + hf * 8 + 2 * tq) : 0u;
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[W::kCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < W::kCols / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    cp_async_wait_upto(kSubs - 1 - s);
    __syncthreads();  // sub-tile s is in shared memory for every warp
    if constexpr (Q) {
      widen_sub<D>(sStK, sStV, sK, sV, s);
      __syncthreads();  // and widened to bf16
    }
    if (!has_rows) continue;
    const bf16* tk = sK + s * kSub * L::kLd;
    const bf16* tv = sV + s * kSub * L::kLd;
    const int* tp = sPos + s * kSub;
    const float* tks = sKs + s * kSub;
    const float* tvs = sVs + s * kSub;

    float sc[kSub / 8][4];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < kSub / 16; ++j2) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        unsigned bk[4];
        ldsm_x4(bk, tk + (j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * L::kLd + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(sc[2 * j2], aq[kk], bk[0], bk[1]);
        mma(sc[2 * j2 + 1], aq[kk], bk[2], bk[3]);
      }
    }

    // fp32 online softmax on the fragments: element e of n-tile j is row
    // g + 8 (e >> 1), key 8 j + 2 tq + (e & 1)
    unsigned okbits = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = 8 * j + 2 * tq + (e & 1);
        const bool ok = rok[i] && usable(tp[key], qp[i], window);
        okbits |= (ok ? 1u : 0u) << (4 * j + e);
        float x = sc[j][e];
        if constexpr (Q) x *= tks[key];  // (q·k)·k_scale, then the scale
        sc[j][e] = ok ? x * scale : kNegInf;
        mx[i] = fmaxf(mx[i], sc[j][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (okbits >> (4 * j + e)) & 1u ? expf(sc[j][e] - m[e >> 1]) : 0.f;
        sum[e >> 1] += p;
        // l sums p; the value mix takes p·v_scale (int8 form)
        sc[j][e] = Q ? p * tvs[8 * j + 2 * tq + (e & 1)] : p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int nt = 0; nt < W::kCols / 8; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    // acc += P V with P = hi + lo, two bf16 A fragments from the S
    // fragments (P to about 16 bits, as fp32 probabilities over bf16 V
    // give; in the int8 form P·v_scale over V widened to bf16), V by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      unsigned hi[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float p0 = sc[2 * kk + (f >> 1)][2 * (f & 1)];
        const float p1 = sc[2 * kk + (f >> 1)][2 * (f & 1) + 1];
        const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
        hi[f] = (unsigned)__bfloat16_as_ushort(h0) | ((unsigned)__bfloat16_as_ushort(h1) << 16);
        lo[f] = pack_bf16(p0 - __bfloat162float(h0), p1 - __bfloat162float(h1));
      }
#pragma unroll
      for (int n2 = 0; n2 < W::kCols / 16; ++n2) {
        unsigned bv[4];
        ldsm_x4_t(bv, tv + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::kLd + c0 +
                          n2 * 16 + (lane >> 4) * 8);
        mma(o[2 * n2], hi, bv[0], bv[1]);
        mma(o[2 * n2 + 1], hi, bv[2], bv[3]);
        mma(o[2 * n2], lo, bv[0], bv[1]);
        mma(o[2 * n2 + 1], lo, bv[2], bv[3]);
      }
    }
  }

  if (!has_rows) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    float* a = acc_ws + (long long)rr[i] * D + c0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < W::kCols / 8; ++nt)
      *reinterpret_cast<float2*>(a + nt * 8) = make_float2(o[nt][2 * i], o[nt][2 * i + 1]);
    if (tq == 0 && c0 == 0) ml_ws[rr[i]] = make_float2(m[i], l[i]);
  }
}

// One warp per query row: the chunks' partials in chunk order -> out, in
// the output's dtype (bf16 for the dense form, q's for the MLA form); dv
// value columns, at most 32 * kCols.
template <int kCols, typename TO>
__global__ void __launch_bounds__(128)
paged_attention_combine_kernel(const float* __restrict__ ws, TO* __restrict__ out, int BKV,
                               int T_, int KV, int G, int nch, int dv) {
  const int R = T_ * G;
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= (long long)BKV * R) return;
  const int lane = threadIdx.x & 31;
  const int bh = (int)(row / R), r = (int)(row % R);
  const float2* ml = reinterpret_cast<const float2*>(ws + (long long)BKV * nch * R * dv) +
                     (long long)bh * nch * R + r;
  const float* acc = ws + ((long long)bh * nch * R + r) * dv;
  // m* = max m over the chunks with l > 0, their (m, l) one a lane
  float mstar = kNegInf;
  for (int s = lane; s < nch; s += 32) {
    const float2 x = ml[(long long)s * R];
    if (x.y > 0.f) mstar = fmaxf(mstar, x.x);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) mstar = fmaxf(mstar, __shfl_xor_sync(0xffffffffu, mstar, d));
  // then the chunks with l > 0 in chunk order (the order of the sums, so a
  // row's bits depend on its own partials alone), a lane's columns each; a
  // chunk with l_s = 0 has acc_s = 0 and was not written. The next such
  // chunk's acc is loaded while the current one is added.
  float o[kCols], cur[kCols], nxt[kCols], lsum = 0.f;
#pragma unroll
  for (int u = 0; u < kCols; ++u) o[u] = cur[u] = nxt[u] = 0.f;
  auto load = [&](float(&dst)[kCols], int s) {
    const float* a = acc + (long long)s * R * dv;
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = lane + 32 * u;
      dst[u] = c < dv ? a[c] : 0.f;
    }
  };
  for (int s0 = 0; s0 < nch; s0 += 32) {
    const float2 x = s0 + lane < nch ? ml[(long long)(s0 + lane) * R]
                                     : make_float2(kNegInf, 0.f);
    const float w = expf(x.x - mstar);
    unsigned live = __ballot_sync(0xffffffffu, x.y > 0.f);
    int i = live ? __ffs(live) - 1 : -1;
    if (i >= 0) load(cur, s0 + i);
    while (i >= 0) {
      live &= live - 1;
      const int j = live ? __ffs(live) - 1 : -1;
      if (j >= 0) load(nxt, s0 + j);
      const float wi = __shfl_sync(0xffffffffu, w, i);
      const float li = __shfl_sync(0xffffffffu, x.y, i);
      lsum += li * wi;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        o[u] += cur[u] * wi;
        cur[u] = nxt[u];
      }
      i = j;
    }
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  const int b = bh / KV, h = bh % KV, t = r / G, gg = r % G;
  TO* orow = out + ((((long long)b * T_ + t) * KV + h) * G + gg) * dv;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int c = lane + 32 * u;
    if (c < dv) orow[c] = from_f<TO>(o[u] * inv);
  }
}

template <int D, bool Q>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kscale,
                   const void* vscale, const int* cpos, const int* table, const int* pos0,
                   float* ws, void* out, int B, int T_, int KV, int G, int ps, int P,
                   float scale, int window, cudaStream_t stream) {
  const int R = T_ * G, S = P * ps;
  const int chunk = chunk_len(B, KV, R, S);
  const int nch = (S + chunk - 1) / chunk;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_split_kernel<D, Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<D, Q>::kBytes);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid(B * KV, (R + Tile<D>::kRows - 1) / Tile<D>::kRows, nch);
  paged_attention_split_kernel<D, Q><<<grid, kThreads, Smem<D, Q>::kBytes, stream>>>(
      static_cast<const bf16*>(q), k, v, static_cast<const bf16*>(kscale),
      static_cast<const bf16*>(vscale), cpos, table, pos0, ws, T_, KV, G, ps, P, chunk, nch,
      scale, window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rows = (long long)B * KV * R;
  paged_attention_combine_kernel<(D + 31) / 32, bf16><<<(unsigned)((rows + 3) / 4), 128, 0,
                                                       stream>>>(
      ws, static_cast<bf16*>(out), B * KV, T_, KV, G, nch, D);
  return cudaGetLastError();
}

}  // namespace split

// ===================================================================
// MLA form, fp32 queries over bf16 latent pages (r % 16 == 0, dr % 16 == 0,
// r <= 512, dr <= 512): the split design above for one latent kv head, with
// keys [ckv (r) | kpe (dr)] and values the ckv rows again.
//
// Bound, as above: bytes. deepseek-v2-lite-16b's decode step has 16 query
// rows (one per head) over 576-wide keys: the template kernel, one block per
// (slot, 16-row tile) walking every key alone in fp32 FMA, kept 4 SMs busy
// at T 1. Here:
//
// - Split, as the dense form: grid (B, 16-row tiles, key chunks), the
//   chunk boundaries at multiples of split::kChunk = 64 in the virtual index
//   (split::chunk_len: never chosen from B, T or the grid), a chunk that no
//   row of the tile can use written as an empty partial, the partials (m, l,
//   acc[r]) in an fp32 workspace ((B, chunks, T*H, r), then (m, l)), and the
//   dense form's combine kernel (at dv = r, out in fp32) takes the chunks in
//   order.
// - Loads. The chunk's key rows [ckv | kpe] (64 x 576 bf16 = 72 KB at
//   deepseek's widths) come in by cp.async, 16 bytes a copy, as two commit
//   groups of 32 keys; a key with no stored position is zero-filled, not
//   read. While they fly, the block's 16 fp32 query rows (contiguous in q)
//   come in by 16-byte loads, several in flight a thread, and go to shared
//   memory as two bf16 rows, hi = bf16(q) and lo = bf16(q - hi) (about 16
//   bits of q, as rmsnorm_matmul's hi/lo rows; within 1e-5 of the plain
//   version at deepseek's widths. A third term, 24 bits, measured 3.5x
//   closer and 40% slower, and moved the same greedy tokens: PERF.md). Rows are padded by 16 bytes so
//   ldmatrix is free of bank conflicts. About 110 KB a block: two an SM.
// - Scores on the tensor cores: S = Q_hi K^T + Q_lo K^T on mma.sync.m16n8k16
//   (fp32 accumulators, one set for each product, added at the end), A
//   fragments of both rows and K fragments by ldmatrix, over the r + dr
//   columns in order.
// - Values split over the warps. A 16-row tile's accumulator is 16 x r fp32
//   (512 columns at deepseek's width: too many registers for one warp), so
//   each of the 4 warps owns r / 4 value columns. Every warp computes the
//   whole S of the tile itself (the same instructions on the same shared
//   data: bitwise the same S, max and sum in every warp) rather than
//   exchanging P through shared memory: the kernel waits on its loads, and
//   the repeated products need no barrier. The fp32 online softmax and P =
//   hi + lo (two bf16 A fragments) are the dense form's; P V runs on
//   mma.sync against ckv fragments by ldmatrix.trans from the key tile.
//
// The bitwise contracts of the dense form hold for the same reasons: a row's
// scores, softmax, partials and combine read only that row's values, in an
// order fixed by the constant chunk layout, so row t of a T 16 call is
// bitwise a one-token call at pos0 + t.
namespace mla_split {

using bf16 = __nv_bfloat16;
using split::kChunk;
using split::kSub;
using split::kSubs;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;          // query rows per block: one m16 tile, shared by the warps
constexpr int kMaxWidth = 512;     // r and dr at most: 16-column value groups <= 8 a warp

// bf16 per shared row of dq = r + dr columns (16 bytes of padding)
__host__ __device__ __forceinline__ int row_ld(int dq) { return dq + 8; }

constexpr int kQLoads = 6;         // 16-byte q loads in flight a thread

// q rows hi and lo, the chunk's key rows, then its stored positions and rows
size_t smem_bytes(int dq) {
  return (size_t)(2 * kRows + kChunk) * row_ld(dq) * sizeof(bf16) + 2 * kChunk * sizeof(int);
}

// x as two bf16, hi = bf16(x) and lo = bf16(x - hi): about 16 bits of x
__device__ __forceinline__ void split_hilo(float x, unsigned& hi, unsigned& lo) {
  const bf16 h = __float2bfloat16_rn(x);
  const float rest = x - __bfloat162float(h);
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(rest));
}

// NG: 16-column value groups a warp holds at most (r <= 64 * NG)
template <int NG>
__global__ void __launch_bounds__(kThreads)
paged_attention_mla_split_kernel(const float* __restrict__ q, const bf16* __restrict__ ckv,
                                 const bf16* __restrict__ kpe, const int* __restrict__ cpos,
                                 const int* __restrict__ table, const int* __restrict__ pos0,
                                 float* __restrict__ ws, int T_, int H, int r, int dr, int ps,
                                 int P, int chunk, int nch, float scale, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dq = r + dr, L = row_ld(dq);
  bf16* sQh = reinterpret_cast<bf16*>(smem);
  bf16* sQl = sQh + kRows * L;
  bf16* sK = sQl + kRows * L;
  int* sPos = reinterpret_cast<int*>(sK + kChunk * L);
  int* sRow = sPos + kChunk;

  const int b = blockIdx.x, z = blockIdx.z;
  const int R = T_ * H;
  const int rb0 = blockIdx.y * kRows, rb1 = min(R, rb0 + kRows);  // the block's rows
  const int j0 = z * chunk;
  const int n = min(chunk, P * ps - j0);  // keys of this chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = pos0[b];
  const int t_lo = rb0 / H, t_hi = (rb1 - 1) / H;
  const long long part = ((long long)b * nch + z) * R;  // this partial's row 0
  float* acc_ws = ws + part * r;
  float2* ml_ws = reinterpret_cast<float2*>(ws + (long long)gridDim.x * nch * R * r) + part;

  bool live = false;
  for (int jj = tid; jj < kChunk; jj += kThreads) {
    int c = -1, row = 0;
    if (jj < n) {
      const int j = j0 + jj;
      row = table[(long long)b * P + j / ps] * ps + j % ps;
      c = cpos[row];
    }
    sPos[jj] = c;
    sRow[jj] = row;
    live |= c >= 0 && c <= p0 + t_hi && (window == 0 || p0 + t_lo - c < window);
  }
  if (!__syncthreads_or(live)) {  // no usable key for the tile: an empty partial
    for (int rr = rb0 + tid; rr < rb1; rr += kThreads) ml_ws[rr] = make_float2(kNegInf, 0.f);
    return;
  }

  // the chunk's key rows [ckv | kpe]: sub-tile s is commit group s
  const int nv = dq / 8;  // 16-byte copies a row
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    for (int e = tid; e < kSub * nv; e += kThreads) {
      const int jj = s * kSub + e / nv, c = (e % nv) * 8;
      const bool ok = sPos[jj] >= 0;
      const long long row = sRow[jj];
      const bf16* src = !ok ? ckv : c < r ? ckv + row * r + c : kpe + row * dr + (c - r);
      cp_async16(sK + jj * L + c, src, ok);
    }
    cp_async_commit();
  }
  // meanwhile the tile's query rows (contiguous in q) as hi / lo bf16, rows
  // past R zero: 16-byte loads, kQLoads of them in flight before the stores
  {
    const float4* qt = reinterpret_cast<const float4*>(q + ((long long)b * R + rb0) * dq);
    const int w4 = dq / 4, n4 = kRows * w4, live4 = (rb1 - rb0) * w4;
    for (int e0 = tid; e0 < n4; e0 += kThreads * kQLoads) {
      float4 x[kQLoads];
#pragma unroll
      for (int u = 0; u < kQLoads; ++u) {
        const int e = e0 + u * kThreads;
        x[u] = e < live4 ? qt[e] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kQLoads; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= n4) break;
        const float v[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
        unsigned h[4], lo[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) split_hilo(v[k], h[k], lo[k]);
        const int off = (e / w4) * L + (e % w4) * 4;  // 8-byte aligned
        *reinterpret_cast<uint2*>(sQh + off) = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
        *reinterpret_cast<uint2*>(sQl + off) =
            make_uint2(lo[0] | lo[1] << 16, lo[2] | lo[3] << 16);
      }
    }
  }

  // lane holds rows g and g + 8 of the tile, columns 2 tq, 2 tq + 1
  const int g = lane >> 2, tq = lane & 3;
  int rr[2], qp[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rr[i] = rb0 + g + 8 * i;
    rok[i] = rr[i] < rb1;
    qp[i] = p0 + (rok[i] ? rr[i] / H : 0);
  }
  // this warp's 16-column value groups: [g0, g0 + ng)
  const int per = (r / 16 + kWarps - 1) / kWarps;
  const int g0 = warp * per, ng = max(0, min(per, r / 16 - g0));

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[2 * NG][4];
#pragma unroll
  for (int nt = 0; nt < 2 * NG; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    cp_async_wait_upto(kSubs - 1 - s);
    __syncthreads();  // sub-tile s (and, first, the q rows) in shared memory
    const bf16* tk = sK + s * kSub * L;
    const int* tp = sPos + s * kSub;

    // S = Q_hi K^T + Q_lo K^T, the two products in their own accumulators
    // (twice the independent mma chains), added once at the end
    float sc[kSub / 8][4], sl[kSub / 8][4];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sl[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < dq / 16; ++kk) {
      unsigned ah[4], al[4];
      const int qoff = (lane & 15) * L + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(ah, sQh + qoff);
      ldsm_x4(al, sQl + qoff);
#pragma unroll
      for (int j2 = 0; j2 < kSub / 16; ++j2) {
        unsigned bk[4];
        ldsm_x4(bk, tk + (j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * L + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(sc[2 * j2], ah, bk[0], bk[1]);
        mma(sc[2 * j2 + 1], ah, bk[2], bk[3]);
        mma(sl[2 * j2], al, bk[0], bk[1]);
        mma(sl[2 * j2 + 1], al, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] += sl[j][e];

    // fp32 online softmax on the fragments, as the dense form's
    unsigned okbits = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = rok[i] && usable(tp[8 * j + 2 * tq + (e & 1)], qp[i], window);
        okbits |= (ok ? 1u : 0u) << (4 * j + e);
        sc[j][e] = ok ? sc[j][e] * scale : kNegInf;
        mx[i] = fmaxf(mx[i], sc[j][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (okbits >> (4 * j + e)) & 1u ? expf(sc[j][e] - m[e >> 1]) : 0.f;
        sc[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int nt = 0; nt < 2 * NG; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    // acc += P V over this warp's value columns, P = hi + lo, V = the ckv
    // columns of the key tile by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      unsigned hi[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float pa = sc[2 * kk + (f >> 1)][2 * (f & 1)];
        const float pb = sc[2 * kk + (f >> 1)][2 * (f & 1) + 1];
        const bf16 ha = __float2bfloat16_rn(pa), hb = __float2bfloat16_rn(pb);
        hi[f] = (unsigned)__bfloat16_as_ushort(ha) | ((unsigned)__bfloat16_as_ushort(hb) << 16);
        lo[f] = pack_bf16(pa - __bfloat162float(ha), pb - __bfloat162float(hb));
      }
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        if (u >= ng) break;
        unsigned bv[4];
        ldsm_x4_t(bv, tk + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * L + (g0 + u) * 16 +
                          (lane >> 4) * 8);
        mma(o[2 * u], hi, bv[0], bv[1]);
        mma(o[2 * u + 1], hi, bv[2], bv[3]);
        mma(o[2 * u], lo, bv[0], bv[1]);
        mma(o[2 * u + 1], lo, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    float* a = acc_ws + (long long)rr[i] * r + 2 * tq;
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      if (u >= ng) break;
      float* c = a + (g0 + u) * 16;
      *reinterpret_cast<float2*>(c) = make_float2(o[2 * u][2 * i], o[2 * u][2 * i + 1]);
      *reinterpret_cast<float2*>(c + 8) =
          make_float2(o[2 * u + 1][2 * i], o[2 * u + 1][2 * i + 1]);
    }
    if (warp == 0 && tq == 0) ml_ws[rr[i]] = make_float2(m[i], l[i]);
  }
}

template <int NG>
cudaError_t launch(const float* q, const bf16* ckv, const bf16* kpe, const int* cpos,
                   const int* table, const int* pos0, float* ws, float* out, int B, int T_,
                   int H, int r, int dr, int ps, int P, float scale, int window,
                   cudaStream_t stream) {
  const int R = T_ * H, S = P * ps;
  const int chunk = split::chunk_len(B, 1, R, S);
  const int nch = (S + chunk - 1) / chunk;
  const size_t smem = smem_bytes(r + dr);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidConfiguration;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_mla_split_kernel<NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const dim3 grid(B, (R + kRows - 1) / kRows, nch);
  paged_attention_mla_split_kernel<NG><<<grid, kThreads, smem, stream>>>(
      q, ckv, kpe, cpos, table, pos0, ws, T_, H, r, dr, ps, P, chunk, nch, scale, window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rows = (long long)B * R;
  split::paged_attention_combine_kernel<2 * NG, float>
      <<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(ws, out, B, T_, 1, H, nch, r);
  return cudaGetLastError();
}

}  // namespace mla_split
}  // namespace

// Dense form: q (B, T, KV, G, d), k / v pages (NP, ps, KV, d), out like q.
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* cpos, const void* table, const void* pos0,
                               void* out, int B, int T, int KV, int G, int d, int NP,
                               int ps, int P, float scale, int window, int q_code,
                               int kv_code, void* stream) {
  if (B <= 0 || KV <= 0 || T <= 0 || G <= 0 || d <= 0) return 0;
  if (NP <= 0 || ps <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<kDense>(q, k, v, nullptr, nullptr, cpos, table, pos0, out, B, T, KV, G, d,
                          d, d, ps, P, scale, window, q_code, kv_code, stream);
}

// MLA form: q (B, T, 1, H, r + dr) rows [q_abs | q_pe], ckv pages (NP, ps, 1, r),
// kpe pages (NP, ps, 1, dr), out (B, T, 1, H, r) in q's dtype.
extern "C" int paged_attention_mla(const void* q, const void* ckv, const void* kpe,
                                   const void* cpos, const void* table, const void* pos0,
                                   void* out, int B, int T, int H, int r, int dr, int NP,
                                   int ps, int P, float scale, int window, int q_code,
                                   int kv_code, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || r <= 0) return 0;
  if (dr <= 0 || NP <= 0 || ps <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<kMla>(q, ckv, kpe, nullptr, nullptr, cpos, table, pos0, out, B, T, 1, H,
                        r + dr, r, r, ps, P, scale, window, q_code, kv_code, stream);
}

// int8 form: q (B, T, KV, G, d) in q_code's dtype, int8 k / v pages
// (NP, ps, KV, d), bf16 k / v scale pages (NP, ps, KV), out like q.
extern "C" int paged_attention_quant(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* cpos, const void* table, const void* pos0,
                                     void* out, int B, int T, int KV, int G, int d, int NP,
                                     int ps, int P, float scale, int window, int q_code,
                                     void* stream) {
  if (B <= 0 || KV <= 0 || T <= 0 || G <= 0 || d <= 0) return 0;
  if (NP <= 0 || ps <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<kQuant>(q, k, v, k_scale, v_scale, cpos, table, pos0, out, B, T, KV, G, d,
                          d, d, ps, P, scale, window, q_code, 0, stream);
}

// Bytes of dynamic shared memory one block needs for R query rows per
// (slot, kv head) of width dq with dv-wide values, in the dense (form 0),
// MLA (1) or int8 (2) form (0 when above the limit), so the caller can
// reject a head width before launching.
extern "C" int paged_attention_smem(int R, int dq, int dv, int form) {
  const size_t smem = smem_floats(R, dq, dv, form) * sizeof(float);
  return smem > (size_t)kMaxSmem ? 0 : (int)smem;
}

namespace {
// the split kernel at head width d (16-128, a multiple of 16, or 256); Q: int8 form
template <bool Q>
int split_dispatch(const void* q, const void* k, const void* v, const void* kscale,
                   const void* vscale, const void* cpos, const void* table, const void* pos0,
                   void* ws, void* out, int B, int T, int KV, int G, int d, int NP, int ps, int P,
                   float scale, int window, void* stream) {
  if (B <= 0 || KV <= 0 || T <= 0 || G <= 0) return 0;
  if (NP <= 0 || ps <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cp = static_cast<const int*>(cpos);
  const int* tb = static_cast<const int*>(table);
  const int* p0 = static_cast<const int*>(pos0);
  float* w = static_cast<float*>(ws);
#define PA_SPLIT(D)                                                                         \
  case D:                                                                                   \
    return (int)split::launch<D, Q>(q, k, v, kscale, vscale, cp, tb, p0, w, out, B, T, KV, G, \
                                    ps, P, scale, window, s)
  switch (d) {
    PA_SPLIT(16);
    PA_SPLIT(32);
    PA_SPLIT(48);
    PA_SPLIT(64);
    PA_SPLIT(80);
    PA_SPLIT(96);
    PA_SPLIT(112);
    PA_SPLIT(128);
    PA_SPLIT(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PA_SPLIT
}
}  // namespace

// Dense form, bf16 q over bf16 pages with d % 16 == 0 and d <= 128, or d = 256: keys
// split over chunks (namespace split). ws: the workspace of
// paged_attention_split_chunk's layout, (B*KV * chunks * T*G * (d + 2)) fp32
// with chunks = ceil(P*ps / chunk).
extern "C" int paged_attention_split(const void* q, const void* k, const void* v,
                                     const void* cpos, const void* table, const void* pos0,
                                     void* ws, void* out, int B, int T, int KV, int G, int d,
                                     int NP, int ps, int P, float scale, int window,
                                     void* stream) {
  return split_dispatch<false>(q, k, v, nullptr, nullptr, cpos, table, pos0, ws, out, B, T, KV,
                               G, d, NP, ps, P, scale, window, stream);
}

// int8 form, bf16 q over int8 k / v pages (NP, ps, KV, d) with bf16 k / v
// scale pages (NP, ps, KV), d % 16 == 0 and d <= 128, or d = 256: keys split over
// chunks (namespace split, Q = true); out (B, T, KV, G, d) bf16; ws as
// paged_attention_split's.
extern "C" int paged_attention_quant_split(const void* q, const void* k, const void* v,
                                           const void* k_scale, const void* v_scale,
                                           const void* cpos, const void* table,
                                           const void* pos0, void* ws, void* out, int B, int T,
                                           int KV, int G, int d, int NP, int ps, int P,
                                           float scale, int window, void* stream) {
  return split_dispatch<true>(q, k, v, k_scale, v_scale, cpos, table, pos0, ws, out, B, T, KV,
                              G, d, NP, ps, P, scale, window, stream);
}

// MLA form, fp32 q over bf16 pages with r % 16 == 0, dr % 16 == 0, r <= 512
// and dr <= 512: keys split over chunks (namespace mla_split). q (B, T, 1,
// H, r + dr), ckv pages (NP, ps, 1, r), kpe pages (NP, ps, 1, dr), out (B,
// T, 1, H, r) fp32; ws: (B * chunks * T*H * (r + 2)) fp32 with chunks =
// ceil(P*ps / chunk), chunk = paged_attention_split_chunk(B, 1, T*H, P*ps).
extern "C" int paged_attention_mla_split(const void* q, const void* ckv, const void* kpe,
                                         const void* cpos, const void* table, const void* pos0,
                                         void* ws, void* out, int B, int T, int H, int r, int dr,
                                         int NP, int ps, int P, float scale, int window,
                                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (NP <= 0 || ps <= 0 || P <= 0 || r <= 0 || dr <= 0 || r % 16 || dr % 16 ||
      r > mla_split::kMaxWidth || dr > mla_split::kMaxWidth)
    return (int)cudaErrorInvalidValue;
  const int groups = (r / 16 + mla_split::kWarps - 1) / mla_split::kWarps;  // a warp's
#define PA_MLA(NG)                                                                          \
  return (int)mla_split::launch<NG>(                                                        \
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(ckv),                 \
      static_cast<const __nv_bfloat16*>(kpe), static_cast<const int*>(cpos),                \
      static_cast<const int*>(table), static_cast<const int*>(pos0), static_cast<float*>(ws), \
      static_cast<float*>(out), B, T, H, r, dr, ps, P, scale, window,                       \
      static_cast<cudaStream_t>(stream))
  if (groups <= 2) PA_MLA(2);
  if (groups <= 4) PA_MLA(4);
  PA_MLA(8);
#undef PA_MLA
}

// The key chunk length paged_attention_split uses for B slots, KV kv heads,
// R = T*G query rows per (slot, kv head) and S = P*ps keys per slot, so the
// caller can size the workspace (a constant in fact: see split::chunk_len).
extern "C" int paged_attention_split_chunk(int B, int KV, int R, int S) {
  return split::chunk_len(B, KV, R, S);
}
