"""Per-layer blocks (port of ``repro/models/blocks.py``): the attention kinds
``'global'`` / ``'local'`` with a serial block and a dense FFN. Other kinds
(recurrent, hybrid), the parallel block, MoE and MLA raise
``NotImplementedError`` until they are ported.

``block_preproj`` is THE PAPER's position-independent first-layer
computation; ``pre`` (its named pieces, gathered from the precomputed
table) short-circuits layer 0's norm and projections in ``block_decode``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.ffn import ffn_apply, ffn_schema

ATTN_KINDS = ('global', 'local')


def _supported(cfg: ModelConfig, kind: str, use_moe: bool) -> None:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f'layer kind {kind!r} is not ported yet')
    if cfg.block_type != 'serial' or use_moe or cfg.mla is not None:
        raise NotImplementedError(
            'only the serial block with a dense FFN and GQA attention is '
            'ported yet')


def kind_window(cfg: ModelConfig, kind: str) -> int:
    if kind in ('local', 'hybrid'):
        return cfg.window
    return 0


def kind_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == 'local' and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


def block_schema(cfg: ModelConfig, kind: str, use_moe: bool) -> Dict:
    _supported(cfg, kind, use_moe)
    d = cfg.d_model
    return {'ln1': L.norm_schema(d, cfg.norm),
            'attn': A.attention_schema(cfg),
            'ln2': L.norm_schema(d, cfg.norm),
            'ffn': ffn_schema(d, cfg.d_ff, glu=cfg.glu)}


def block_preproj(params: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                  use_moe: bool) -> Dict[str, torch.Tensor]:
    """Position-independent first-layer computation on raw embeddings x:
    ``{'x': x, 'q', 'k', 'v'}`` (serial block)."""
    _supported(cfg, kind, use_moe)
    xn = L.norm_apply(params['ln1'], x, cfg.norm)
    q, k, v = A.compute_qkv(params['attn'], xn, cfg)
    return {'x': x, 'q': q, 'k': k, 'v': v}


def preproj_layout(cfg: ModelConfig, kind: str, use_moe: bool
                   ) -> Tuple[Tuple[str, int], ...]:
    """(name, width) pieces of one precomputed-table row, in storage order."""
    _supported(cfg, kind, use_moe)
    d, q, e = cfg.d_model, cfg.q_size, cfg.kv_size
    return (('x', d), ('q', q), ('k', e), ('v', e))


def block_make_state(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype: torch.dtype = torch.bfloat16, chunk: int = 1,
                     device: torch.device | str = 'cuda', num_pages: int = 0,
                     page_size: int = 0) -> Dict:
    """``num_pages > 0`` builds paged-KV storage (a global page pool
    instead of per-slot caches)."""
    _supported(cfg, kind, False)
    if num_pages:
        return A.make_paged_cache(cfg, num_pages, page_size, dtype=dtype,
                                  device=device)
    return A.make_cache(cfg, batch, seq_len, window=kind_window(cfg, kind),
                        dtype=dtype, chunk=chunk, device=device)


def block_paged_mask(cfg: ModelConfig, kind: str) -> Dict[str, bool]:
    """Same keys as paged :func:`block_make_state`, True on page-pool
    leaves (shared, never slot-reset) — every leaf of an attention kind."""
    _supported(cfg, kind, False)
    return {'k': True, 'v': True, 'pos': True}


def block_decode(params: Dict, h: torch.Tensor, state: Dict,
                 pos: torch.Tensor, cfg: ModelConfig, kind: str,
                 use_moe: bool, *, pre: Optional[Dict] = None,
                 n_valid: Optional[torch.Tensor] = None,
                 rope_applied: bool = False, paged=None, backend=None
                 ) -> Tuple[torch.Tensor, Dict]:
    """Decode step. h (B, T, d); pos (B,) start positions. ``n_valid is
    None`` is the one-token step (T == 1); ``n_valid`` (B,) runs the
    chunked-prefill path. ``paged`` (an ``attention.PageTables``; chunked
    path only) addresses the cache as pool pages. The cache in ``state``
    is updated in place. -> (h_out, state)."""
    _supported(cfg, kind, use_moe)
    assert paged is None or n_valid is not None, \
        'paged decode runs the chunked path'

    theta = kind_theta(cfg, kind)
    window = kind_window(cfg, kind)
    if pre is not None:
        xn, qkv = None, (pre['q'], pre['k'], pre['v'])
    else:
        xn, qkv = L.norm_apply(params['ln1'], h, cfg.norm), None
    if n_valid is not None:
        attn_out, state = A.decode_chunk(
            params['attn'], xn, state, pos, n_valid, cfg, rope_theta=theta,
            window=window, qkv=qkv, rope_applied=rope_applied, paged=paged,
            backend=backend)
    else:
        attn_out, state = A.decode_step(
            params['attn'], xn, state, pos, cfg, rope_theta=theta,
            window=window, qkv=qkv, backend=backend)
    h = h + attn_out
    xn2 = L.norm_apply(params['ln2'], h, cfg.norm)
    return h + ffn_apply(params['ffn'], xn2, act=cfg.act), state
