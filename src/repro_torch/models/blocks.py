"""Per-layer blocks (port of ``repro/models/blocks.py``): the attention kinds
``'global'`` / ``'local'`` with a serial block (GQA or MLA attention,
``cfg.mla``, and a dense or MoE FFN, ``use_moe``) or a parallel block
(``h + attn(LN1(h)) + FFN(LN2(h))``: GQA or MHA attention and a dense or
MoE FFN: pythia-6.9b, mixtral-8x7b-parallel). Other kinds (recurrent,
hybrid) and the parallel block with MLA (no config has one) raise
``NotImplementedError``.

``block_preproj`` is THE PAPER's position-independent first-layer
computation; ``pre`` (its named pieces, gathered from the precomputed
table) short-circuits layer 0's norm and projections in ``block_decode``
and in the full-sequence ``block_apply_full``. In a parallel block the
piece ``'s' = x + FFN(LN2(x))`` also folds layer 0's FFN and skip into the
table, the whole expert FFN where it is MoE (paper §3), so layer 0 then
runs attention alone.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.rmsnorm_qkv import rmsnorm_qkv
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models.ffn import ffn_apply, ffn_schema
from repro_torch.models.moe import moe_apply, moe_schema

ATTN_KINDS = ('global', 'local')


def _supported(cfg: ModelConfig, kind: str) -> None:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f'layer kind {kind!r} is not ported yet')
    if cfg.block_type == 'parallel' and cfg.mla:
        raise NotImplementedError('the parallel block is ported with GQA '
                                  'attention only')


def kind_window(cfg: ModelConfig, kind: str) -> int:
    if kind in ('local', 'hybrid'):
        return cfg.window
    return 0


def kind_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == 'local' and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


def block_schema(cfg: ModelConfig, kind: str, use_moe: bool) -> Dict:
    _supported(cfg, kind)
    d = cfg.d_model
    sch = {'ln1': L.norm_schema(d, cfg.norm),
           'attn': M.mla_schema(cfg) if cfg.mla else A.attention_schema(cfg),
           'ln2': L.norm_schema(d, cfg.norm)}
    if use_moe:
        sch['moe'] = moe_schema(cfg)
    else:
        d_ff = cfg.moe.dense_d_ff if cfg.moe and cfg.moe.dense_d_ff \
            else cfg.d_ff
        sch['ffn'] = ffn_schema(d, d_ff, glu=cfg.glu)
    return sch


def block_preproj(params: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                  use_moe: bool, *, return_drops: bool = False):
    """Position-independent first-layer computation on raw embeddings x
    (B, S, d): ``{'x', 'q', 'k', 'v'}``, or ``{'x', 'q', 'ckv', 'kpe'}``
    for MLA (serial block); ``{'s', 'q', 'k', 'v'}`` for the parallel
    block, with ``s = x + FFN(LN2(x))`` (the skip folded in, per the
    paper). A parallel MoE block runs the whole expert FFN over x with the
    default router and no lane mask, as JAX does: its capacity comes from
    x's row count, so rows can overflow an expert and drop.
    ``return_drops`` -> (pieces, dropped token slots: an int32 scalar
    tensor, zero without a parallel MoE)."""
    _supported(cfg, kind)
    xn = L.norm_apply(params['ln1'], x, cfg.norm)
    drops = None
    if cfg.mla:
        q, ckv, kpe = M.compute_latents(params['attn'], xn, cfg)
        pieces = {'x': x, 'q': q, 'ckv': ckv, 'kpe': kpe}
    else:
        q, k, v = A.compute_qkv(params['attn'], xn, cfg)
        if cfg.block_type == 'parallel':
            xn2 = L.norm_apply(params['ln2'], x, cfg.norm)
            if use_moe:
                f, drops = moe_apply(params['moe'], xn2, cfg)
            else:
                f = ffn_apply(params['ffn'], xn2, act=cfg.act)
            pieces = {'s': x + f, 'q': q, 'k': k, 'v': v}
        else:
            pieces = {'x': x, 'q': q, 'k': k, 'v': v}
    if not return_drops:
        return pieces
    return pieces, torch.zeros((), dtype=torch.int32, device=x.device) \
        if drops is None else drops


def preproj_layout(cfg: ModelConfig, kind: str, use_moe: bool
                   ) -> Tuple[Tuple[str, int], ...]:
    """(name, width) pieces of one precomputed-table row, in storage order."""
    _supported(cfg, kind)
    d, q, e = cfg.d_model, cfg.q_size, cfg.kv_size
    if cfg.mla:
        m = cfg.mla
        return (('x', d), ('q', q), ('ckv', m.kv_lora_rank),
                ('kpe', m.qk_rope_dim))
    first = 's' if cfg.block_type == 'parallel' else 'x'
    return ((first, d), ('q', q), ('k', e), ('v', e))


def block_apply_full(params: Dict, h: torch.Tensor, positions: torch.Tensor,
                     cfg: ModelConfig, kind: str, use_moe: bool, *,
                     pre: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block: h (B, S, d), positions (B, S) -> (h_out, aux
    loss: a float32 scalar, the MoE's load-balance loss or zero). ``pre``
    (precomputed rows) supplies layer 0's q/k/v (MLA: q/c_kv/k_pe; and, in
    a parallel block, ``s``, which replaces LN2, the FFN or the whole MoE,
    and the skip: no aux loss then); otherwise LN1 and the Q/K/V
    projections are :func:`_full_qkv` (MLA: LN1 and ``mla_full``'s own
    projections), so the baseline and the precomputed forward differ only
    in layer 0. The serial MoE routes ``'softmax_topk'`` with shared
    experts, else ``'topk_softmax'``; the parallel one takes the default,
    as in JAX."""
    _supported(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    theta = kind_theta(cfg, kind)
    if cfg.mla:
        xn = L.norm_apply(params['ln1'], h, cfg.norm) if pre is None \
            else None
        lat = None if pre is None else (pre['q'], pre['ckv'], pre['kpe'])
        attn_out = M.mla_full(params['attn'], xn, positions, cfg,
                              rope_theta=theta, latents=lat)
    else:
        qkv = _full_qkv(params, h, cfg) if pre is None \
            else (pre['q'], pre['k'], pre['v'])
        attn_out = A.full_attention(params['attn'], None, positions, cfg,
                                    rope_theta=theta,
                                    window=kind_window(cfg, kind), qkv=qkv)
    if cfg.block_type == 'parallel':
        if pre is not None:
            return pre['s'] + attn_out, aux
        xn2 = L.norm_apply(params['ln2'], h, cfg.norm)
        if use_moe:
            f, aux, _ = moe_apply(params['moe'], xn2, cfg, with_aux=True)
        else:
            f = ffn_apply(params['ffn'], xn2, act=cfg.act)
        return h + attn_out + f, aux
    h = h + attn_out
    xn2 = L.norm_apply(params['ln2'], h, cfg.norm)
    if use_moe:
        f, aux, _ = moe_apply(params['moe'], xn2, cfg,
                              router_mode=serial_router_mode(cfg),
                              with_aux=True)
        return h + f, aux
    return h + ffn_apply(params['ffn'], xn2, act=cfg.act), aux


def serial_router_mode(cfg: ModelConfig) -> str:
    """The serial MoE block's router: softmax over all experts, then top-k
    (DeepSeek) with shared experts, else top-k then softmax (Mixtral)."""
    return 'softmax_topk' if cfg.moe and cfg.moe.num_shared \
        else 'topk_softmax'


def _full_qkv(params: Dict, h: torch.Tensor, cfg: ModelConfig) -> Tuple:
    """LN1 and the Q/K/V projections of a full sequence: with RMSNorm one
    fused ``rmsnorm_qkv`` (the ``rmsnorm_matmul`` kernel on the card), then
    ``qk_norm`` where the config has it (:func:`attention.qk_normalize`);
    with LayerNorm the norm and ``torch.matmul``, as JAX leaves them to XLA
    outside any Pallas kernel."""
    a = params['attn']
    if cfg.norm == 'rmsnorm':
        q, k, v = rmsnorm_qkv(h, params['ln1']['scale'], a['wq']['w'],
                              a['wk']['w'], a['wv']['w'])
        q, k = A.qk_normalize(a, q, k, cfg)
        return q, k, v
    return A.compute_qkv(a, L.norm_apply(params['ln1'], h, cfg.norm), cfg)


def block_make_state(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype: torch.dtype = torch.bfloat16, chunk: int = 1,
                     device: torch.device | str = 'cuda', num_pages: int = 0,
                     page_size: int = 0, quant: bool = False) -> Dict:
    """``num_pages > 0`` builds paged-KV storage (a global page pool
    instead of per-slot caches); ``quant`` makes K/V caches int8 with
    scales (MLA latent caches ignore it, as in JAX)."""
    _supported(cfg, kind)
    if cfg.mla:
        if num_pages:
            return M.mla_make_paged_cache(cfg, num_pages, page_size, dtype,
                                          device)
        return M.mla_make_cache(cfg, batch, seq_len, dtype, device)
    if num_pages:
        return A.make_paged_cache(cfg, num_pages, page_size, dtype=dtype,
                                  quant=quant, device=device)
    return A.make_cache(cfg, batch, seq_len, window=kind_window(cfg, kind),
                        dtype=dtype, quant=quant, chunk=chunk, device=device)


def block_paged_mask(cfg: ModelConfig, kind: str,
                     quant: bool = False) -> Dict[str, bool]:
    """Same keys as paged :func:`block_make_state`, True on page-pool
    leaves (shared, never slot-reset) — every leaf of an attention kind."""
    _supported(cfg, kind)
    if cfg.mla:
        return {'ckv': True, 'kpe': True, 'pos': True}
    m = {'k': True, 'v': True, 'pos': True}
    if quant:
        m.update(k_scale=True, v_scale=True)
    return m


def block_decode(params: Dict, h: torch.Tensor, state: Dict,
                 pos: torch.Tensor, cfg: ModelConfig, kind: str,
                 use_moe: bool, *, pre: Optional[Dict] = None,
                 n_valid: Optional[torch.Tensor] = None,
                 rope_applied: bool = False, paged=None,
                 lane_valid: Optional[torch.Tensor] = None, backend=None,
                 packed=None) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Decode step. h (B, T, d); pos (B,) start positions. ``n_valid is
    None`` is the one-token step (T == 1); ``n_valid`` (B,) runs the
    chunked-prefill path. ``paged`` (an ``attention.PageTables``; chunked
    path only) addresses the cache as pool pages. ``lane_valid`` (B,)
    bool marks live slots of the one-token step, so MoE routing leaves
    free slots out; the chunked path masks lanes ``t >= n_valid``. The
    cache in ``state`` is updated in place. -> (h_out, state,
    moe_dropped_token_slots).

    ``packed`` (an ``attention.PackedLayout``; chunked path only): ``h``
    and ``pre`` lie on the bin-packed (R, T) grid while ``pos``,
    ``n_valid`` and ``state`` stay slot-major. Norms, FFN / MoE and
    residuals run packed; the mixer's inputs go to the slot-major layout
    (``packed.to_slots``), it runs the unpacked code against the unpacked
    caches, and its output comes back (``packed.to_lanes``). MoE takes the
    slot-major capacity and ties broken by the canonical lane index, so
    routing and drops do not depend on the packing."""
    _supported(cfg, kind)
    chunked = n_valid is not None
    assert paged is None or chunked, 'paged decode runs the chunked path'
    assert packed is None or chunked, 'packed decode runs the chunked path'
    if packed is not None:
        ts, tl = packed.to_slots, packed.to_lanes
    else:
        def ts(x):
            return x
        tl = ts

    theta = kind_theta(cfg, kind)
    window = kind_window(cfg, kind)
    xn = None if pre is not None else ts(L.norm_apply(params['ln1'], h,
                                                      cfg.norm))
    if cfg.mla:
        lat = None if pre is None else (ts(pre['q']), ts(pre['ckv']),
                                        ts(pre['kpe']))
        if chunked:
            attn_out, state = M.mla_decode_chunk(
                params['attn'], xn, state, pos, n_valid, cfg,
                rope_theta=theta, latents=lat, rope_applied=rope_applied,
                paged=paged, backend=backend)
        else:
            attn_out, state = M.mla_decode_step(
                params['attn'], xn, state, pos, cfg, rope_theta=theta,
                latents=lat, backend=backend)
    else:
        qkv = None if pre is None else (ts(pre['q']), ts(pre['k']),
                                        ts(pre['v']))
        if chunked:
            attn_out, state = A.decode_chunk(
                params['attn'], xn, state, pos, n_valid, cfg,
                rope_theta=theta, window=window, qkv=qkv,
                rope_applied=rope_applied, paged=paged, backend=backend)
        else:
            attn_out, state = A.decode_step(
                params['attn'], xn, state, pos, cfg, rope_theta=theta,
                window=window, qkv=qkv, backend=backend)
    attn_out = tl(attn_out)

    def ffn(xn2, router_mode):
        """The dense FFN, or the MoE with the step's lane mask (JAX's:
        chunk padding and free slots route nowhere; packed prefill takes
        the slot-major capacity and canonical lane order), made only
        where the block has an MoE so that dense steps run none of it."""
        if not use_moe:
            return (ffn_apply(params['ffn'], xn2, act=cfg.act),
                    torch.zeros((), dtype=torch.int32, device=h.device))
        T = h.shape[1]
        moe_kw = {}
        if packed is not None:
            lane_mask = packed.lane_valid
            moe_kw = dict(capacity_tokens=pos.shape[0] * T,
                          lane_order=packed.lane_slot * T
                          + packed.lane_local)
        elif chunked:
            lane_mask = torch.arange(T, device=h.device)[None] \
                < n_valid.long()[:, None]
        else:
            lane_mask = None if lane_valid is None else lane_valid[:, None]
        return moe_apply(params['moe'], xn2, cfg, router_mode=router_mode,
                         lane_mask=lane_mask, **moe_kw)

    if cfg.block_type == 'parallel':
        if pre is not None:     # layer 0: the table's s holds LN2 + FFN
            return pre['s'] + attn_out, state, torch.zeros(
                (), dtype=torch.int32, device=h.device)
        f, drops = ffn(L.norm_apply(params['ln2'], h, cfg.norm),
                       'topk_softmax')
        return h + attn_out + f, state, drops
    h = h + attn_out
    f, drops = ffn(L.norm_apply(params['ln2'], h, cfg.norm),
                   serial_router_mode(cfg))
    return h + f, state, drops
