"""Per-layer blocks (port of ``repro/models/blocks.py``): the attention kinds
``'global'`` / ``'local'`` with a serial block (GQA or MLA attention,
``cfg.mla``, and a dense or MoE FFN, ``use_moe``) or a parallel block
(``h + attn(LN1(h)) + FFN(LN2(h))``: GQA or MHA attention and a dense or
MoE FFN: pythia-6.9b, mixtral-8x7b-parallel); the recurrent kinds
``'mlstm'`` / ``'slstm'`` (xLSTM, ``models/ssm.py``); and the hybrid kinds
``'hybrid'`` / ``'hybrid_global'`` (Hymba: windowed or full attention
beside mamba heads over one LN1, the two branches RMS-normed, averaged
and projected by ``w_out``, then LN2 and the FFN). The parallel block
with MLA (no config has one) raises ``NotImplementedError``.

A hybrid layer's state is one flat dict: the attention cache's leaves
(``k``, ``v``, ``pos`` and, int8, the scales) beside the mamba state's
``S`` and ``conv`` (JAX nests them as ``{'attn': ..., 'ssm': ...}``), so
the engine walks every layer as one flat dict of leaves.

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
from repro_torch.models import ssm as S
from repro_torch.models.ffn import ffn_apply, ffn_schema
from repro_torch.models.moe import moe_apply, moe_schema

ATTN_KINDS = ('global', 'local')
HYBRID_KINDS = ('hybrid', 'hybrid_global')
RECURRENT_KINDS = ('mlstm', 'slstm')
# the attention cache's leaves inside a hybrid layer's flat state
ATTN_LEAVES = ('k', 'v', 'pos', 'k_scale', 'v_scale')


def _supported(cfg: ModelConfig, kind: str) -> None:
    if kind not in ATTN_KINDS + HYBRID_KINDS + RECURRENT_KINDS:
        raise ValueError(kind)
    if kind in ATTN_KINDS and cfg.block_type == 'parallel' and cfg.mla:
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
    if kind in RECURRENT_KINDS:
        return {'ln1': L.norm_schema(d, cfg.norm),
                'core': S.mlstm_schema(cfg) if kind == 'mlstm'
                else S.slstm_schema(cfg)}
    if kind in HYBRID_KINDS:
        attn = A.attention_schema(cfg)
        del attn['wo']                      # one output proj after the mix
        ed = cfg.num_heads * cfg.head_dim
        return {'ln1': L.norm_schema(d, cfg.norm), 'attn': attn,
                'mamba': S.mamba_schema(cfg),
                'norm_attn': {'scale': L.ParamSpec((ed,), 'ones')},
                'norm_ssm': {'scale': L.ParamSpec((ed,), 'ones')},
                'w_out': L.dense_schema(ed, d),
                'ln2': L.norm_schema(d, cfg.norm),
                'ffn': ffn_schema(d, cfg.d_ff, glu=cfg.glu)}
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
    tensor, zero without a parallel MoE). The recurrent and hybrid kinds:
    ``{'x', 'u1', 'u2', 'v', 'ifg'}`` (mLSTM), ``{'x', 'z_in', 'o_in'}``
    (sLSTM), ``{'x', 'q', 'k', 'v', 'x_in', 'gate'}`` (hybrid)."""
    _supported(cfg, kind)
    xn = L.norm_apply(params['ln1'], x, cfg.norm)
    drops = None
    if kind == 'mlstm':
        pieces = dict(x=x, **S.mlstm_preproj(params['core'], xn))
    elif kind == 'slstm':
        sp = S.slstm_preproj(params['core'], xn)
        pieces = {'x': x, 'z_in': sp['z_in'], 'o_in': sp['o_in']}
    elif kind in HYBRID_KINDS:
        q, k, v = A.compute_qkv(params['attn'], xn, cfg)
        pieces = dict(x=x, q=q, k=k, v=v,
                      **S.mamba_preproj(params['mamba'], xn))
    elif cfg.mla:
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
    if kind == 'mlstm':
        ed, H, _ = S.mlstm_dims(cfg)
        return (('x', d), ('u1', ed), ('u2', ed), ('v', ed), ('ifg', 2 * H))
    if kind == 'slstm':
        return (('x', d), ('z_in', d), ('o_in', d))
    if kind in HYBRID_KINDS:
        ed = cfg.num_heads * cfg.head_dim
        return (('x', d), ('q', q), ('k', e), ('v', e), ('x_in', ed),
                ('gate', ed))
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
    as in JAX. The recurrent kinds run LN1 and the recurrence (``pre``:
    layer 0's precomputed projections; sLSTM still norms h for its conv);
    the hybrid kinds norm once for both branches (LN1 and the projections
    as torch ops, as JAX's hybrid block: no ``rmsnorm_matmul`` launch),
    attend through :func:`attention.attention_core` and run the mamba
    heads over the whole sequence."""
    _supported(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    theta = kind_theta(cfg, kind)
    if kind == 'mlstm':
        if pre is not None:
            y = S.mlstm_apply(params['core'], None, cfg,
                              pre={k: pre[k] for k in ('u1', 'u2', 'v',
                                                       'ifg')})
        else:
            y = S.mlstm_apply(params['core'],
                              L.norm_apply(params['ln1'], h, cfg.norm), cfg)
        return h + y, aux
    if kind == 'slstm':
        xn = L.norm_apply(params['ln1'], h, cfg.norm)
        spre = None if pre is None else \
            {'z_in': pre['z_in'], 'o_in': pre['o_in'], 'xn': xn}
        return h + S.slstm_apply(params['core'], xn, cfg, pre=spre), aux
    if kind in HYBRID_KINDS:
        if pre is not None:
            xn, qkv = None, (pre['q'], pre['k'], pre['v'])
            mpre = {'x_in': pre['x_in'], 'gate': pre['gate']}
        else:
            xn = L.norm_apply(params['ln1'], h, cfg.norm)
            qkv, mpre = A.compute_qkv(params['attn'], xn, cfg), None
        ctx = A.attention_core(*qkv, positions, cfg, rope_theta=theta,
                               window=kind_window(cfg, kind))
        y_ssm = S.mamba_apply(params['mamba'], xn, cfg, pre=mpre)
        return _hybrid_out(params, h, ctx, y_ssm, cfg), aux
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


def _hybrid_out(params: Dict, h: torch.Tensor, ctx: torch.Tensor,
                y_ssm: torch.Tensor, cfg: ModelConfig,
                tl=lambda x: x) -> torch.Tensor:
    """The hybrid block after its two branches: each RMS-normed, their
    mean (``tl``: taken from the slot-major layout to h's packed grid)
    projected by ``w_out`` onto the residual, then LN2 and the FFN."""
    mix = 0.5 * (L.rmsnorm(ctx, params['norm_attn']['scale'])
                 + L.rmsnorm(y_ssm, params['norm_ssm']['scale']))
    h = h + L.dense(params['w_out'], tl(mix))
    return h + ffn_apply(params['ffn'], L.norm_apply(params['ln2'], h,
                                                     cfg.norm), act=cfg.act)


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
    scales (MLA latent caches ignore it, as in JAX). Recurrent kinds:
    their per-slot state (``ssm.*_init_state``); hybrid kinds: the
    attention cache's leaves and the mamba state's ``S`` / ``conv`` in one
    flat dict."""
    _supported(cfg, kind)
    if kind == 'mlstm':
        return S.mlstm_init_state(cfg, batch, device)
    if kind == 'slstm':
        return S.slstm_init_state(cfg, batch, device)
    if kind in HYBRID_KINDS:
        if num_pages:
            st = A.make_paged_cache(cfg, num_pages, page_size, dtype=dtype,
                                    quant=quant, device=device)
        else:
            st = A.make_cache(cfg, batch, seq_len,
                              window=kind_window(cfg, kind), dtype=dtype,
                              quant=quant, chunk=chunk, device=device)
        st.update(S.mamba_init_state(cfg, batch, device))
        return st
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
    leaves (shared, never slot-reset): every leaf of an attention kind and
    a hybrid layer's attention leaves; recurrent and conv state is per
    slot (reset, snapshot and restore by slot row), never pooled."""
    _supported(cfg, kind)
    if kind in RECURRENT_KINDS + HYBRID_KINDS:
        proto = block_make_state(cfg, kind, 1, 1, device='meta',
                                 num_pages=1, page_size=1, quant=quant)
        return {nm: kind in HYBRID_KINDS and nm in ATTN_LEAVES
                for nm in proto}
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
    if kind in RECURRENT_KINDS + HYBRID_KINDS:     # no MoE: no drops
        zero = torch.zeros((), dtype=torch.int32, device=h.device)
    if kind == 'mlstm':
        if pre is not None:
            y, _ = S.mlstm_step(params['core'], None, state, cfg,
                                pre={k: ts(pre[k]) for k in
                                     ('u1', 'u2', 'v', 'ifg')},
                                n_valid=n_valid)
        else:
            y, _ = S.mlstm_step(params['core'],
                                ts(L.norm_apply(params['ln1'], h, cfg.norm)),
                                state, cfg, n_valid=n_valid)
        return h + tl(y), state, zero
    if kind == 'slstm':
        xn = ts(L.norm_apply(params['ln1'], h, cfg.norm))
        spre = None if pre is None else \
            {'z_in': ts(pre['z_in']), 'o_in': ts(pre['o_in']), 'xn': xn}
        y, _ = S.slstm_step(params['core'], xn, state, cfg, pre=spre,
                            n_valid=n_valid)
        return h + tl(y), state, zero
    if kind in HYBRID_KINDS:
        return _hybrid_decode(params, h, state, pos, cfg, kind, pre=pre,
                              n_valid=n_valid, paged=paged, backend=backend,
                              ts=ts, tl=tl), state, zero
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


def _hybrid_decode(params: Dict, h: torch.Tensor, state: Dict,
                   pos: torch.Tensor, cfg: ModelConfig, kind: str, *, pre,
                   n_valid, paged, backend, ts, tl) -> torch.Tensor:
    """A hybrid layer's decode step (``block_decode``): LN1 once (or the
    table's q / k / v / x_in / gate rows), the attention branch against
    the layer's cache leaves (one token, or the chunk's write and attend),
    the mamba branch's step (or masked chunk) on its ``S`` / ``conv``
    leaves, both in place; then :func:`_hybrid_out`. Hybrid rows never
    come from the fused gather→RoPE (``transformer.fused_rope_eligible``),
    so k and q are rotated here."""
    theta, window = kind_theta(cfg, kind), kind_window(cfg, kind)
    if pre is not None:
        xn, qkv = None, (ts(pre['q']), ts(pre['k']), ts(pre['v']))
        mpre = {'x_in': ts(pre['x_in']), 'gate': ts(pre['gate'])}
    else:
        xn = ts(L.norm_apply(params['ln1'], h, cfg.norm))
        qkv, mpre = A.compute_qkv(params['attn'], xn, cfg), None
    cache = {nm: state[nm] for nm in ATTN_LEAVES if nm in state}
    if n_valid is not None:
        ctx = A.chunk_context(params['attn'], None, cache, pos, n_valid, cfg,
                              rope_theta=theta, window=window, qkv=qkv,
                              paged=paged, backend=backend)
    else:
        ctx = A.step_context(params['attn'], None, cache, pos, cfg,
                             rope_theta=theta, window=window, qkv=qkv,
                             backend=backend)
    y_ssm, _ = S.mamba_step(params['mamba'], xn, state, cfg, pre=mpre,
                            n_valid=n_valid)
    return _hybrid_out(params, h, ctx, y_ssm, cfg, tl)
