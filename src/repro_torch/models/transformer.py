"""Decoder-only LM assembly (port of ``repro/models/transformer.py``): the
full-sequence forward (``lm_apply``) and decode/serving (``lm_decode_step``).

Layer 0 is always unstacked: with a precomputed table it consumes gathered
``[x, q, k, v]`` rows (``[s, q, k, v]`` for a parallel block, whose ``s``
is the first hidden state) instead of running its norm and projections,
and nothing after it changes. The remaining layers repeat the config's pattern:
``body[s]`` holds pattern slot s's parameters and caches stacked over
``reps`` (a Python loop over reps replaces JAX's ``lax.scan``; each rep
reads views of the stacked tensors, so cache updates land in place), and a
short unstacked ``tail`` covers non-divisible depths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.blocks import (ATTN_KINDS, block_apply_full,
                                       block_decode, block_make_state,
                                       block_paged_mask, block_preproj,
                                       kind_theta)
from repro_torch.params import tree_slice


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    kinds: Tuple[str, ...]          # kind of every layer, in order
    use_moe: Tuple[bool, ...]       # per layer
    n_head: int                     # unstacked layers after layer 0
    reps: int                       # repetitions of the pattern
    slots: Tuple[str, ...]          # rotated pattern (kind per slot)
    n_tail: int


def layer_plan(cfg: ModelConfig) -> LayerPlan:
    P = len(cfg.pattern)
    kinds = tuple(cfg.pattern[i % P] for i in range(cfg.num_layers))
    n_dense = cfg.moe.first_dense_layers if cfg.moe else 0
    use_moe = tuple(cfg.moe is not None and i >= n_dense
                    for i in range(cfg.num_layers))
    n_head = max(0, n_dense - 1)            # layer 0 is peeled separately
    start = 1 + n_head
    remaining = cfg.num_layers - start
    slots = tuple(cfg.pattern[(start + s) % P] for s in range(P))
    reps = remaining // P
    n_tail = remaining - reps * P
    return LayerPlan(kinds, use_moe, n_head, reps, slots, n_tail)


# ============================================================ embed / head
def embed_tokens(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding rows in the model's dtype (times sqrt(d) where the config
    scales them); learned absolute positions (``cfg.pos == 'learned'``)
    add ``pos_embed[positions]``, which sits between the embedding and the
    Q/K/V projections, so such a model has no table (paper §2)."""
    h = L.embed_lookup(params['embed'], tokens).to(getattr(torch, cfg.dtype))
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    if cfg.pos == 'learned':
        assert positions is not None, 'learned positions need positions'
        h = h + L.take_rows(params['pos_embed'], positions).to(h.dtype)
    return h


def lm_head(params: Dict, h_normed: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = h_normed @ params['embed']['table'].T
    else:
        logits = L.dense(params['lm_head'], h_normed)
    return L.softcap(logits, cfg.logit_softcap)


def lm_logits(params: Dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return lm_head(params, L.norm_apply(params['final_norm'], h, cfg.norm),
                   cfg)


# ================================================================== full seq
def backbone_apply(params: Dict, h: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, *, pre0: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run every layer on initial hidden states h (B, S, d); ``pre0`` holds
    layer 0's precomputed rows. -> (h, the MoE load-balance loss summed
    over layers, a float32 scalar)."""
    plan = layer_plan(cfg)
    if plan.n_head:
        raise NotImplementedError(
            'unstacked head layers (first_dense_layers > 1) are not ported')
    h, aux = block_apply_full(params['layer0'], h, positions, cfg,
                              plan.kinds[0], plan.use_moe[0], pre=pre0)
    for r in range(plan.reps):
        for s, kind in enumerate(plan.slots):
            h, a = block_apply_full(tree_slice(params['body'][s], r), h,
                                    positions, cfg, kind, plan.use_moe[1])
            aux = aux + a
    for i in range(plan.n_tail):
        h, a = block_apply_full(params['tail'][i], h, positions, cfg,
                                plan.slots[i], plan.use_moe[-1])
        aux = aux + a
    return h, aux


def lm_apply(params: Dict, tokens: torch.Tensor, cfg: ModelConfig, *,
             precomputed=None, return_hidden: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) at positions 0 .. S-1 (after ``cfg.num_meta_tokens``
    meta tokens, whose positions come first and whose rows are dropped
    before the head) -> (logits (B, S, V), aux loss). With ``precomputed`` (a ``core.precompute.PrecomputedTable``,
    the paper's feature) the embedding read and layer 0's norm and Q/K/V
    projections are one row gather per token. ``return_hidden`` returns
    the final-normed hidden states instead of logits."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    if precomputed is not None:
        pre0 = precomputed.gather(tokens)
        h = pre0['s'] if 's' in pre0 else pre0['x']
    else:
        pre0 = None
        h = embed_tokens(params, tokens, cfg, positions)
    M = cfg.num_meta_tokens
    if M:
        # Hymba's learnable meta tokens lead the sequence at positions
        # 0 .. M-1; the text follows them
        h = torch.cat([params['meta'].to(h.dtype)[None].expand(B, M, -1), h],
                      dim=1)
        mpos = torch.arange(M, dtype=torch.int32,
                            device=tokens.device)[None].expand(B, M)
        positions = torch.cat([mpos, positions + M], dim=1)
        if pre0 is not None:
            # meta tokens are no vocabulary entries: their layer-0 pieces
            # are computed on the fly and lead the gathered rows
            plan = layer_plan(cfg)
            mpre = block_preproj(params['backbone']['layer0'], h[:, :M], cfg,
                                 plan.kinds[0], plan.use_moe[0])
            pre0 = {k: torch.cat([mpre[k].to(v.dtype), v], dim=1)
                    for k, v in pre0.items()}
            h = pre0['s'] if 's' in pre0 else pre0['x']
    h, aux = backbone_apply(params['backbone'], h, positions, cfg, pre0=pre0)
    h = L.norm_apply(params['final_norm'], h, cfg.norm)
    if M:
        h = h[:, M:]
    if return_hidden:
        return h, aux
    return lm_head(params, h, cfg), aux


# ==================================================================== decode
def backbone_make_states(cfg: ModelConfig, batch: int, seq_len: int,
                         dtype: torch.dtype = torch.bfloat16, chunk: int = 1,
                         device: torch.device | str = 'cuda',
                         num_pages: int = 0, page_size: int = 0,
                         quant: bool = False) -> Dict:
    """Per-layer caches; ``num_pages > 0`` makes every attention cache a
    (num_pages, page_size, ...) pool (stacked over reps for ``body``);
    ``quant`` makes K/V caches int8 with scales."""
    plan = layer_plan(cfg)
    if plan.n_head:
        raise NotImplementedError(
            'unstacked head layers (first_dense_layers > 1) are not ported')

    def mk(kind):
        return block_make_state(cfg, kind, batch, seq_len, dtype, chunk,
                                device, num_pages, page_size, quant)

    st: Dict[str, Any] = {'layer0': mk(plan.kinds[0])}
    if plan.reps:
        st['body'] = [{nm: leaf[None].repeat((plan.reps,) + (1,) * leaf.dim())
                       for nm, leaf in mk(k).items()} for k in plan.slots]
    if plan.n_tail:
        st['tail'] = [mk(plan.slots[i]) for i in range(plan.n_tail)]
    return st


def backbone_paged_mask(cfg: ModelConfig, quant: bool = False) -> Dict:
    """Bool tree matching paged :func:`backbone_make_states`: True on
    page-pool leaves, False on per-slot state."""
    plan = layer_plan(cfg)
    st: Dict[str, Any] = {
        'layer0': block_paged_mask(cfg, plan.kinds[0], quant)}
    if plan.reps:
        st['body'] = [block_paged_mask(cfg, k, quant) for k in plan.slots]
    if plan.n_tail:
        st['tail'] = [block_paged_mask(cfg, plan.slots[i], quant)
                      for i in range(plan.n_tail)]
    return st


def backbone_decode(params: Dict, h: torch.Tensor, states: Dict,
                    pos: torch.Tensor, cfg: ModelConfig, *,
                    pre0: Optional[Dict] = None,
                    n_valid: Optional[torch.Tensor] = None,
                    rope_applied: bool = False, paged=None,
                    lane_valid: Optional[torch.Tensor] = None,
                    attn_backend=None, packed=None
                    ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """``n_valid is None``: one-token step (h is (B, 1, d)); with
    ``n_valid`` (B,): chunked step over h (B, T, d). ``paged`` (an
    ``attention.PageTables``) addresses the caches as pool pages;
    ``lane_valid`` (B,) masks free slots out of MoE routing in the
    one-token step; ``packed`` (an ``attention.PackedLayout``) puts h on
    the bin-packed grid (``blocks.block_decode``). Caches in ``states`` are
    updated in place; returns (h, states, MoE dropped token slots summed
    over layers, an int32 tensor on h's device)."""
    plan = layer_plan(cfg)
    kw = dict(n_valid=n_valid, paged=paged, lane_valid=lane_valid,
              backend=attn_backend, packed=packed)
    h, _, drops = block_decode(params['layer0'], h, states['layer0'], pos,
                               cfg, plan.kinds[0], plan.use_moe[0], pre=pre0,
                               rope_applied=rope_applied, **kw)
    for r in range(plan.reps):
        for s, kind in enumerate(plan.slots):
            h, _, d = block_decode(tree_slice(params['body'][s], r), h,
                                   tree_slice(states['body'][s], r), pos,
                                   cfg, kind, plan.use_moe[1], **kw)
            drops = drops + d
    for i in range(plan.n_tail):
        h, _, d = block_decode(params['tail'][i], h, states['tail'][i], pos,
                               cfg, plan.slots[i], plan.use_moe[-1], **kw)
        drops = drops + d
    return h, states, drops


def prime_meta_states(params: Dict, states: Dict, cfg: ModelConfig,
                      batch: int, attn_backend=None) -> Dict:
    """Feed the learnable meta tokens (Hymba) through the one-token decode
    path, in place, so that the caches and recurrent states of all
    ``batch`` slots start as if the meta prefix had been prefilled; token
    positions then start at ``cfg.num_meta_tokens``."""
    dtype = getattr(torch, cfg.dtype)
    for i in range(cfg.num_meta_tokens):
        h = params['meta'][i].to(dtype)[None, None] \
            .expand(batch, 1, cfg.d_model).contiguous()
        pos = torch.full((batch,), i, dtype=torch.int32, device=h.device)
        backbone_decode(params['backbone'], h, states, pos, cfg,
                        attn_backend=attn_backend)
    return states


def lm_decode_step(params: Dict, tokens: torch.Tensor, states: Dict,
                   pos: torch.Tensor, cfg: ModelConfig, *, precomputed=None,
                   n_valid: Optional[torch.Tensor] = None,
                   return_hidden: bool = False,
                   fused_gather_rope: bool = False, paged=None,
                   lane_valid: Optional[torch.Tensor] = None,
                   return_stats: bool = False, attn_backend=None,
                   packed=None):
    """tokens (B, T), pos (B,) -> (logits (B, T, V), states).

    ``n_valid is None`` is the one-token step (T == 1); with ``n_valid``
    (B,) the whole chunk advances in one call: slot b's tokens sit at
    ``pos[b] .. pos[b] + n_valid[b] - 1``, later lanes are padding (never
    written to a cache; their outputs are garbage). With ``precomputed``
    the embedding read and layer 0's projections are one row gather per
    token; ``fused_gather_rope`` (chunked path) also rotates layer 0's
    rotary slices inside that gather. ``paged`` (an
    ``attention.PageTables``; chunked path) addresses the caches as pool
    pages. ``lane_valid`` (B,) bool masks free slots out of MoE routing in
    the one-token step. ``return_hidden`` skips the final norm and head;
    ``return_stats`` appends ``{'moe_drops': int32 tensor}``.

    ``packed`` (an ``attention.PackedLayout``; chunked path) runs the
    segment-packed layout: ``tokens`` is the bin-packed (R, T) grid, each
    lane's position is ``packed.lane_pos``, and the hidden / logit grid
    returned is packed (a slot's rows sit at ``packed.seg_row`` /
    ``packed.seg_off``); ``pos``, ``n_valid`` and ``states`` stay
    slot-major.
    """
    assert packed is None or n_valid is not None, \
        'packed prefill runs the chunked path'
    rope_applied = False

    def lane_positions():
        # each lane's position: pos (one-token step), pos + t (chunk) or
        # the packed grid's lane_pos
        if n_valid is None:
            return pos[:, None]
        if packed is not None:
            return packed.lane_pos
        T = tokens.shape[1]
        return pos[:, None].long() + torch.arange(T, device=pos.device)
    if precomputed is not None:
        if n_valid is not None and fused_gather_rope \
                and fused_rope_eligible(precomputed, cfg):
            pre0 = _fused_gather_rope_pre0(precomputed, tokens,
                                           lane_positions(), cfg)
            rope_applied = True
        else:
            pre0 = precomputed.gather(tokens)
        h = pre0['s'] if 's' in pre0 else pre0['x']
    else:
        pre0 = None
        h = embed_tokens(params, tokens, cfg, lane_positions()
                         if cfg.pos == 'learned' else None)
    h, states, drops = backbone_decode(
        params['backbone'], h, states, pos, cfg, pre0=pre0, n_valid=n_valid,
        rope_applied=rope_applied, paged=paged, lane_valid=lane_valid,
        attn_backend=attn_backend, packed=packed)
    out = h if return_hidden else lm_logits(params, h, cfg)
    if return_stats:
        return out, states, {'moe_drops': drops}
    return out, states


def fused_rope_eligible(precomputed, cfg: ModelConfig) -> bool:
    """Can layer 0's row gather fold RoPE in? True for rope-positional
    attention-first stacks whose row carries the flat q/k layout (GQA) or
    the MLA latent layout (per-head ``[qk_nope | qk_rope]`` q slices plus
    the shared ``k_pe``)."""
    if precomputed is None or cfg.pos != 'rope':
        return False
    if layer_plan(cfg).kinds[0] not in ATTN_KINDS:
        return False
    names = [nm for nm, _ in precomputed.layout]
    if cfg.mla is not None:
        return 'q' in names and 'ckv' in names and 'kpe' in names
    return 'q' in names and 'k' in names


def fused_rope_segments(layout, cfg: ModelConfig
                        ) -> Tuple[Tuple[int, int, int], ...]:
    """The ``(offset, heads, head_dim)`` segments of a precomputed row
    (``layout``: its ``(name, width)`` pieces) that the fused gather
    rotates: the q and k heads for GQA; each head's ``qk_rope`` slice plus
    ``k_pe`` for MLA (H + 1 segments of width qk_rope_dim)."""
    offs, off = {}, 0
    for nm, w in layout:
        offs[nm] = off
        off += w
    if cfg.mla is not None:
        dn, dr = cfg.mla.qk_nope_dim, cfg.mla.qk_rope_dim
        return tuple((offs['q'] + h * (dn + dr) + dn, 1, dr)
                     for h in range(cfg.num_heads)) + ((offs['kpe'], 1, dr),)
    hd = cfg.head_dim
    return ((offs['q'], cfg.num_heads, hd), (offs['k'], cfg.num_kv_heads, hd))


def _fused_gather_rope_pre0(precomputed, tokens: torch.Tensor,
                            pos_t: torch.Tensor,
                            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Layer-0 rows via the fused gather→RoPE kernel: one table read per
    token with the rotary slices (:func:`fused_rope_segments`) already
    rotated for their positions."""
    from repro_torch.kernels.gather_rope import gather_rope
    assert fused_rope_eligible(precomputed, cfg)
    theta = kind_theta(cfg, layer_plan(cfg).kinds[0])
    rows = gather_rope(precomputed.table,
                       tokens.reshape(-1).to(torch.int32).contiguous(),
                       pos_t.reshape(-1).to(torch.int32).contiguous(),
                       segs=fused_rope_segments(precomputed.layout, cfg),
                       theta=theta)
    return precomputed.split(rows.reshape(tuple(tokens.shape) + (-1,)))
