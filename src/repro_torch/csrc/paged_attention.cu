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
// Design: the T*G query rows of one (slot, kv head) are split into tiles of
// at most kRowTile = 64 rows (kRowTileMla = 16 in the MLA form, whose 576-wide
// query rows and 512-wide accumulators would not fit 64 rows in shared
// memory), one block per (slot, kv head, row tile), so any chunk length and
// group size fit and the grid grows with the chunk. Each block keeps its rows
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
