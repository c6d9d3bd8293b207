"""DeepSeek-V2 Multi-head Latent Attention (port of ``repro/models/mla.py``:
decode, serving and the full-sequence ``mla_full``).

MLA compresses K/V into a low-rank latent ``c_kv`` (kv_lora_rank wide)
plus a small decoupled RoPE key ``k_pe`` shared across heads; only
``(c_kv, k_pe)`` is cached. Every layer-0 MLA projection is
position-independent — ``q = W_Q·LN(x)`` (pre-RoPE), ``c_kv =
RMSNorm(W_DKV·LN(x))`` and the pre-RoPE ``k_pe`` — so the paper's table
row is ``[x, q, c_kv, k_pe]``. RoPE on ``q_pe``/``k_pe`` and the
up-projections W_UK/W_UV (which read the cache) stay at run time.

The full-sequence forward (:func:`mla_full`) uses the non-absorbed form,
as JAX does: W_UK / W_UV expand the latents into per-head keys and values
and the attention is the plain O(S^2) one (torch ops, as JAX leaves it to
XLA outside any Pallas kernel). Decode uses the absorbed form: W_UK is
folded into the query, so scores are taken against the latent cache
directly, and W_UV is applied after the value mix.

Caches are dicts ``{'ckv': (B, Sc, r), 'kpe': (B, Sc, dr), 'pos': (B, Sc)
int32}`` (``pos`` -1 = never written), or the paged pool's ``(num_pages,
page_size, ...)`` leaves; like the GQA caches they are **updated in
place**, with contents equal to JAX's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def mla_schema(cfg: ModelConfig) -> Dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    dq = m.qk_nope_dim + m.qk_rope_dim
    sch = {
        'wq': L.dense_schema(d, H * dq),
        'wdkv': L.dense_schema(d, m.kv_lora_rank + m.qk_rope_dim),
        'kv_norm': {'scale': L.ParamSpec((m.kv_lora_rank,), 'ones')},
        'wuk': L.ParamSpec((m.kv_lora_rank, H, m.qk_nope_dim)),
        'wuv': L.ParamSpec((m.kv_lora_rank, H, m.v_head_dim)),
        'wo': L.dense_schema(H * m.v_head_dim, d),
    }
    if m.q_lora_rank:
        sch['wdq'] = L.dense_schema(d, m.q_lora_rank)
        sch['q_norm'] = {'scale': L.ParamSpec((m.q_lora_rank,), 'ones')}
        sch['wq'] = L.dense_schema(m.q_lora_rank, H * dq)
    return sch


# ------------------------------------------------- position-independent part
def compute_latents(params: Dict, x_normed: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q flat pre-RoPE, c_kv post-norm, k_pe pre-RoPE) — the
    precomputable set."""
    m = cfg.mla
    if m.q_lora_rank:
        cq = L.rmsnorm(L.dense(params['wdq'], x_normed),
                       params['q_norm']['scale'])
        q = L.dense(params['wq'], cq)
    else:
        q = L.dense(params['wq'], x_normed)
    ckv_kpe = L.dense(params['wdkv'], x_normed)
    c_kv = L.rmsnorm(ckv_kpe[..., :m.kv_lora_rank],
                     params['kv_norm']['scale'])
    return q, c_kv, ckv_kpe[..., m.kv_lora_rank:]


def _split_q(q: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H*dq) -> q_nope (..., H, dn), q_pe (..., H, dr)."""
    m = cfg.mla
    q = q.reshape(tuple(q.shape[:-1])
                  + (cfg.num_heads, m.qk_nope_dim + m.qk_rope_dim))
    return q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]


def _rope_kpe(k_pe: torch.Tensor, pos_t: torch.Tensor,
              theta: float) -> torch.Tensor:
    """Rotate the shared (B, T, dr) k_pe as one head."""
    return L.apply_rope(k_pe[:, :, None, :], pos_t, theta)[:, :, 0]


# ------------------------------------------------------------------ full seq
def mla_full(params: Dict, x_normed: Optional[torch.Tensor],
             positions: torch.Tensor, cfg: ModelConfig, *, rope_theta: float,
             latents: Optional[Tuple] = None) -> torch.Tensor:
    """Full-sequence MLA, non-absorbed form: x_normed (B, S, d), positions
    (B, S) -> (B, S, d) after the output projection. ``latents`` (q, c_kv,
    k_pe) are the precomputed rows, replacing :func:`compute_latents`.
    fp32 scores; the probabilities take v's dtype before the value mix, as
    in JAX."""
    m = cfg.mla
    q, c_kv, k_pe = compute_latents(params, x_normed, cfg) \
        if latents is None else latents
    B, S = q.shape[0], q.shape[1]
    q_nope, q_pe = _split_q(q, cfg)                    # (B,S,H,dn)/(B,S,H,dr)
    q_pe = L.apply_rope(q_pe, positions, rope_theta)
    k_pe = _rope_kpe(k_pe, positions, rope_theta)
    k_nope = torch.einsum('bsr,rhd->bshd', c_kv, params['wuk'].to(c_kv.dtype))
    v = torch.einsum('bsr,rhd->bshd', c_kv, params['wuv'].to(c_kv.dtype))
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    scores = (torch.einsum('bqhd,bshd->bhqs', q_nope.float(), k_nope.float())
              + torch.einsum('bqhd,bsd->bhqs', q_pe.float(), k_pe.float())
              ) * scale
    i = positions[:, None, :, None]
    j = positions[:, None, None, :]
    scores = scores.masked_fill(~(j <= i), A.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum('bhqs,bshd->bqhd', probs, v)
    return L.dense(params['wo'], ctx.reshape(B, S, -1))


# -------------------------------------------------------------------- caches
def mla_make_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = 'cuda'
                   ) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {
        'ckv': torch.zeros((batch, seq_len, m.kv_lora_rank), dtype=dtype,
                           device=device),
        'kpe': torch.zeros((batch, seq_len, m.qk_rope_dim), dtype=dtype,
                           device=device),
        'pos': torch.full((batch, seq_len), -1, dtype=torch.int32,
                          device=device),
    }


def mla_make_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                         dtype: torch.dtype = torch.bfloat16,
                         device: torch.device | str = 'cuda'
                         ) -> Dict[str, torch.Tensor]:
    """Pool-shaped latent cache: the leaves of :func:`mla_make_cache` with
    (num_pages, page_size) leading axes. Page 0 is the null page."""
    return mla_make_cache(cfg, num_pages, page_size, dtype, device)


def mla_cache_update_chunk(cache: Dict, c_kv: torch.Tensor,
                           k_pe_rot: torch.Tensor, pos0: torch.Tensor,
                           n_valid: torch.Tensor) -> Dict:
    """Whole-chunk latent write, in place: lanes ``t < n_valid[b]`` land at
    ring index ``(pos0 + t) % Sc``; last writer wins where a chunk laps
    the ring (``attention.ring_chunk_write``), equal to sequential
    writes."""
    return A.ring_chunk_write(cache, {'ckv': c_kv, 'kpe': k_pe_rot}, pos0,
                              n_valid)


# -------------------------------------------------------------------- decode
def mla_decode_step(params: Dict, x_normed: Optional[torch.Tensor],
                    cache: Dict, pos: torch.Tensor, cfg: ModelConfig, *,
                    rope_theta: float, latents: Optional[Tuple] = None,
                    backend=None) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-form one-token MLA decode; the latent of this step is
    written (k_pe post-RoPE) at ring index ``pos % Sc`` in place."""
    q, c_kv, k_pe = compute_latents(params, x_normed, cfg) \
        if latents is None else latents
    B = q.shape[0]
    pos_t = pos[:, None].long()
    k_pe_rot = _rope_kpe(k_pe, pos_t, rope_theta)
    Sc = cache['ckv'].shape[1]
    idx = pos.long() % Sc
    bidx = torch.arange(B, device=idx.device)
    cache['ckv'][bidx, idx] = c_kv[:, 0].to(cache['ckv'].dtype)
    cache['kpe'][bidx, idx] = k_pe_rot[:, 0].to(cache['kpe'].dtype)
    cache['pos'][bidx, idx] = pos.to(torch.int32)
    q_nope, q_pe = _split_q(q, cfg)                    # (B,1,H,dn)/(B,1,H,dr)
    q_pe = L.apply_rope(q_pe, pos_t, rope_theta)
    ctx = A._backend(backend, q.device).attend_mla(
        params, q_nope, q_pe, cache, pos, cfg)
    return L.dense(params['wo'], ctx.reshape(B, 1, -1)), cache


def _mla_attend_lane(params: Dict, q_nope: torch.Tensor, q_pe: torch.Tensor,
                     cache: Dict, pos: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Absorbed-form attention of ONE query lane (B, H, ·) at positions
    ``pos`` (B,) against a dense(-shaped) latent cache -> ctx (B, H, dv).
    Shared by the one-token step and, lane by lane, the chunk step, so both
    run identically shaped contractions (chunked == token-by-token)."""
    m = cfg.mla
    q_abs = torch.einsum('bhd,rhd->bhr', q_nope.float(),
                         params['wuk'].float())
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    scores = (torch.einsum('bhr,bsr->bhs', q_abs, cache['ckv'].float())
              + torch.einsum('bhd,bsd->bhs', q_pe.float(),
                             cache['kpe'].float())) * scale
    cp = cache['pos'][:, None, :]
    valid = (cp >= 0) & (cp <= pos[:, None, None])
    scores = scores.masked_fill(~valid, A.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ckv = cache['ckv']
    ctx_lat = torch.einsum('bhs,bsr->bhr', probs.to(ckv.dtype), ckv)
    return torch.einsum('bhr,rhd->bhd', ctx_lat,
                        params['wuv'].to(ctx_lat.dtype))


def mla_decode_chunk(params: Dict, x_normed: Optional[torch.Tensor],
                     cache: Dict, pos0: torch.Tensor, n_valid: torch.Tensor,
                     cfg: ModelConfig, *, rope_theta: float,
                     latents: Optional[Tuple] = None,
                     rope_applied: bool = False,
                     paged: Optional[A.PageTables] = None,
                     backend=None) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-form chunked-prefill MLA: project (or take precomputed
    latents for) a (B, T) chunk, write the valid lanes' ``c_kv``/``k_pe``
    into the cache in one call (in place), attend all T queries. Lane t
    sits at ``pos0 + t``; in-chunk causality falls out of the
    ``stored <= query`` test. ``rope_applied``: the fused gather→RoPE
    kernel already rotated each head's q_pe slice and k_pe. ``paged``
    writes through the linear page table (MLA layers are append-only) with
    ``attention.paged_write``."""
    q, c_kv, k_pe = compute_latents(params, x_normed, cfg) \
        if latents is None else latents
    B, T = q.shape[:2]
    pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
    k_pe_rot = k_pe if rope_applied else _rope_kpe(k_pe, pos_t, rope_theta)
    if paged is None:
        mla_cache_update_chunk(cache, c_kv, k_pe_rot, pos0, n_valid)
    else:
        A.paged_write(cache, {'ckv': c_kv, 'kpe': k_pe_rot}, pos0, n_valid,
                      window=0, paged=paged, backend=backend)
    q_nope, q_pe = _split_q(q, cfg)                    # (B,T,H,dn)/(B,T,H,dr)
    if not rope_applied:
        q_pe = L.apply_rope(q_pe, pos_t, rope_theta)
    ctx = A._backend(backend, q.device).attend_mla(
        params, q_nope, q_pe, cache, pos0, cfg, paged=paged)  # (B,T,H,dv)
    return L.dense(params['wo'], ctx.reshape(B, T, -1)), cache
