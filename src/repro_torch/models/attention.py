"""Grouped-query attention with RoPE against dense (ring) KV caches — the
dense-cache part of ``repro/models/attention.py``.

Caches are dicts ``{'k': (B, Sc, KV, hd), 'v': (B, Sc, KV, hd),
'pos': (B, Sc) int32}``; ``pos`` holds each entry's token position (-1 =
never written), which is all the attend needs to mask ring wraparound,
windows and unwritten rows. Sliding-window layers keep a ring of
``cache_len(window, seq, chunk)`` entries; position p lives at ``p % Sc``.

**Caches are updated in place.** JAX returns new cache arrays; PyTorch runs
eagerly, so :func:`cache_update` and :func:`cache_update_chunk` write the
new entries into the given tensors (which may be views into the stacked
per-layer state) and return the same dict. Contents — ``pos`` included,
ring wraparound and chunks that lap the ring included — equal JAX's
exactly.

How queries read the cache is the attention backend's decision
(``repro_torch.models.attn_backend``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

NEG_INF = -2.0 ** 30   # large-negative that survives bf16


def _backend(backend, device):
    from repro_torch.models.attn_backend import get_backend
    return get_backend(backend, device)


def attention_schema(cfg: ModelConfig) -> Dict:
    d, q, e = cfg.d_model, cfg.q_size, cfg.kv_size
    return {'wq': L.dense_schema(d, q), 'wk': L.dense_schema(d, e),
            'wv': L.dense_schema(d, e),
            'wo': L.dense_schema(cfg.attn_out_size, d)}


# ============================================== the part precompute removes
def compute_qkv(params: Dict, x_normed: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project LN(x) -> (q, k, v), flat head layout, PRE-RoPE — exactly the
    position-independent computation the paper moves into the table."""
    if cfg.qk_norm:
        raise NotImplementedError('qk_norm is not ported yet')
    return (L.dense(params['wq'], x_normed), L.dense(params['wk'], x_normed),
            L.dense(params['wv'], x_normed))


# ================================================================== KV cache
def cache_len(window: int, seq_len: int, chunk: int = 1) -> int:
    """Ring length of a sliding-window cache; ``chunk - 1`` slack rows keep a
    late in-chunk write from evicting a key an early in-chunk query still
    needs."""
    if not window:
        return seq_len
    return min(window + max(0, chunk - 1), seq_len)


def make_cache(cfg: ModelConfig, batch: int, seq_len: int, *, window: int = 0,
               dtype: torch.dtype = torch.bfloat16, chunk: int = 1,
               device: torch.device | str = 'cuda'
               ) -> Dict[str, torch.Tensor]:
    Sc = cache_len(window, seq_len, chunk)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        'k': torch.zeros((batch, Sc, KV, hd), dtype=dtype, device=device),
        'v': torch.zeros((batch, Sc, KV, hd), dtype=dtype, device=device),
        'pos': torch.full((batch, Sc), -1, dtype=torch.int32, device=device),
    }


def cache_update(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> Dict:
    """Write one decode step (B, 1, KV, hd) at ring index ``pos % Sc``, in
    place."""
    Sc = cache['k'].shape[1]
    idx = (pos.long() % Sc)
    bidx = torch.arange(cache['k'].shape[0], device=idx.device)
    cache['k'][bidx, idx] = k_new[:, 0].to(cache['k'].dtype)
    cache['v'][bidx, idx] = v_new[:, 0].to(cache['v'].dtype)
    cache['pos'][bidx, idx] = pos.to(torch.int32)
    return cache


def ring_chunk_lanes(Sc: int, pos0: torch.Tensor, n_valid: torch.Tensor,
                     T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane-side form of JAX's ``ring_chunk_index``: for each chunk lane
    (B, T), the lane whose value it writes and the ring slot it writes.

    Lane ``t < n_valid`` lands on ``(pos0 + t) % Sc``; when a chunk laps the
    ring, the last valid lane landing on a slot wins. Each lane is mapped to
    that winner (lanes ``t >= n_valid`` to the winner of the last valid
    lane), so every write to a slot carries the same value: the scatter is
    deterministic and equals the sequential per-token writes. Returns
    ``(src, slot)``; ``src`` is -1 for slots with ``n_valid == 0``, whose
    lanes must write back what the slot already holds.
    """
    pos0 = pos0.long()[:, None]
    nv = n_valid.long()[:, None]
    t = torch.arange(T, device=pos0.device)[None]
    tv = torch.minimum(t, nv - 1)                       # last valid lane
    src = tv + Sc * torch.div(nv - 1 - tv, Sc, rounding_mode='floor')
    src = torch.where(nv > 0, src, torch.full_like(src, -1))
    slot = (pos0 + tv.clamp(min=0)) % Sc
    return src, slot


def cache_update_chunk(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                       pos0: torch.Tensor, n_valid: torch.Tensor) -> Dict:
    """Write a whole chunk (B, T, KV, hd) at ring indices ``(pos0 + t) %
    Sc`` for ``t < n_valid``, in place — one scatter per leaf instead of T
    (see :func:`ring_chunk_lanes`)."""
    B, T = k_new.shape[:2]
    Sc = cache['k'].shape[1]
    src, slot = ring_chunk_lanes(Sc, pos0, n_valid, T)
    bidx = torch.arange(B, device=slot.device)[:, None].expand(B, T)
    live = src >= 0
    lane = src.clamp(min=0)

    def write(name, new):
        leaf = cache[name]
        old = leaf[bidx, slot]
        val = torch.gather(new, 1, lane.view((B, T) + (1,) * (new.dim() - 2))
                           .expand_as(new)).to(leaf.dtype)
        m = live.view((B, T) + (1,) * (val.dim() - 2))
        leaf[bidx, slot] = torch.where(m, val, old)

    write('k', k_new)
    write('v', v_new)
    write('pos', (pos0.long()[:, None] + lane).to(torch.int32))
    return cache


# ================================================================ decode core
def decode_step(params: Dict, x_normed: Optional[torch.Tensor], cache: Dict,
                pos: torch.Tensor, cfg: ModelConfig, *, rope_theta: float,
                window: int = 0, qkv: Optional[Tuple] = None, backend=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token step: (qkv or projections) -> cache write -> attend -> wo.
    ``qkv`` supplies precomputed (q, k, v) rows for the paper's layer-0
    path."""
    q, k, v = compute_qkv(params, x_normed, cfg) if qkv is None else qkv
    B = q.shape[0]
    k_h = k.reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    if cfg.pos == 'rope':
        k_h = L.apply_rope(k_h, pos[:, None], rope_theta)
    v_h = v.reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    cache_update(cache, k_h, v_h, pos)
    ctx = _backend(backend, q.device).attend_chunk(
        q, cache, pos, cfg, rope_theta=rope_theta, window=window)
    return L.dense(params['wo'], ctx), cache


def _attend_lanes(q: torch.Tensor, cache: Dict, pos_t: torch.Tensor,
                  cfg: ModelConfig, window: int) -> torch.Tensor:
    """Masked softmax attention of (B, T', KV, G, hd) post-RoPE queries at
    positions ``pos_t`` (B, T') against the cache -> (B, T', KV, G, hd)."""
    hd = cfg.head_dim
    scores = torch.einsum('btkgd,bskd->bkgts', q.float(),
                          cache['k'].float()) * hd ** -0.5
    cp = cache['pos'][:, None, None, None, :]                # (B,1,1,1,Sc)
    qp = pos_t[:, None, None, :, None]                       # (B,1,1,T',1)
    valid = (cp >= 0) & (cp <= qp)
    if window:
        valid &= (qp - cp) < window
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    v = cache['v']
    return torch.einsum('bkgts,bskd->btkgd', probs.to(v.dtype), v)


def decode_attend_chunk(q: torch.Tensor, cache: Dict, pos0: torch.Tensor,
                        cfg: ModelConfig, *, rope_theta: float,
                        window: int = 0,
                        rope_applied: bool = False) -> torch.Tensor:
    """T-query attention against the (already chunk-updated) cache, query
    lanes one at a time (the reference backend's attend).

    q: (B, T, q_size) flat; lane t sits at position ``pos0 + t``. In-chunk
    causality needs no extra mask: the chunk's own keys carry their
    positions. ``rope_applied`` skips the q rotation for rows from the
    fused gather→RoPE kernel.
    """
    B, T = q.shape[0], q.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = q.reshape(B, T, H, hd)
    pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
    if cfg.pos == 'rope' and not rope_applied:
        q = L.apply_rope(q, pos_t, rope_theta)
    q = q.reshape(B, T, KV, H // KV, hd)
    ctx = torch.cat([_attend_lanes(q[:, t:t + 1], cache, pos_t[:, t:t + 1],
                                   cfg, window) for t in range(T)], dim=1)
    return ctx.reshape(B, T, H * hd)


def decode_chunk(params: Dict, x_normed: Optional[torch.Tensor], cache: Dict,
                 pos0: torch.Tensor, n_valid: torch.Tensor, cfg: ModelConfig,
                 *, rope_theta: float, window: int = 0,
                 qkv: Optional[Tuple] = None, rope_applied: bool = False,
                 backend=None) -> Tuple[torch.Tensor, Dict]:
    """Chunked-prefill step: project (or take precomputed) a T-token chunk,
    write its valid prefix into the cache in one call, attend all T
    queries. ``rope_applied`` marks gathered rows already rotated by the
    fused kernel."""
    q, k, v = compute_qkv(params, x_normed, cfg) if qkv is None else qkv
    B, T = q.shape[0], q.shape[1]
    k_h = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    if cfg.pos == 'rope' and not rope_applied:
        pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
        k_h = L.apply_rope(k_h, pos_t, rope_theta)
    v_h = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    cache_update_chunk(cache, k_h, v_h, pos0, n_valid)
    ctx = _backend(backend, q.device).attend_chunk(
        q, cache, pos0, cfg, rope_theta=rope_theta, window=window,
        rope_applied=rope_applied)
    return L.dense(params['wo'], ctx), cache
