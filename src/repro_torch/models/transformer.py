"""Decoder-only LM assembly for decode/serving (port of the decode half of
``repro/models/transformer.py``).

Layer 0 is always unstacked: with a precomputed table it consumes gathered
``[x, q, k, v]`` rows instead of running its norm and projections, and
nothing after it changes. The remaining layers repeat the config's pattern:
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
from repro_torch.models.blocks import (ATTN_KINDS, block_decode,
                                       block_make_state, kind_theta)
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
def embed_tokens(params: Dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    if cfg.pos == 'learned':
        raise NotImplementedError('learned positions are not ported yet')
    h = L.embed_lookup(params['embed'], tokens).to(getattr(torch, cfg.dtype))
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
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


# ==================================================================== decode
def backbone_make_states(cfg: ModelConfig, batch: int, seq_len: int,
                         dtype: torch.dtype = torch.bfloat16, chunk: int = 1,
                         device: torch.device | str = 'cuda') -> Dict:
    plan = layer_plan(cfg)
    if plan.n_head:
        raise NotImplementedError('unstacked head layers (MoE) not ported')

    def mk(kind):
        return block_make_state(cfg, kind, batch, seq_len, dtype, chunk,
                                device)

    st: Dict[str, Any] = {'layer0': mk(plan.kinds[0])}
    if plan.reps:
        st['body'] = [{nm: leaf[None].repeat((plan.reps,) + (1,) * leaf.dim())
                       for nm, leaf in mk(k).items()} for k in plan.slots]
    if plan.n_tail:
        st['tail'] = [mk(plan.slots[i]) for i in range(plan.n_tail)]
    return st


def backbone_decode(params: Dict, h: torch.Tensor, states: Dict,
                    pos: torch.Tensor, cfg: ModelConfig, *,
                    pre0: Optional[Dict] = None,
                    n_valid: Optional[torch.Tensor] = None,
                    rope_applied: bool = False, attn_backend=None
                    ) -> Tuple[torch.Tensor, Dict]:
    """``n_valid is None``: one-token step (h is (B, 1, d)); with
    ``n_valid`` (B,): chunked step over h (B, T, d). Caches in ``states``
    are updated in place; returns (h, states)."""
    plan = layer_plan(cfg)
    kw = dict(n_valid=n_valid, backend=attn_backend)
    h, _ = block_decode(params['layer0'], h, states['layer0'], pos, cfg,
                        plan.kinds[0], plan.use_moe[0], pre=pre0,
                        rope_applied=rope_applied, **kw)
    for r in range(plan.reps):
        for s, kind in enumerate(plan.slots):
            h, _ = block_decode(tree_slice(params['body'][s], r), h,
                                tree_slice(states['body'][s], r), pos, cfg,
                                kind, plan.use_moe[1], **kw)
    for i in range(plan.n_tail):
        h, _ = block_decode(params['tail'][i], h, states['tail'][i], pos, cfg,
                            plan.slots[i], plan.use_moe[-1], **kw)
    return h, states


def lm_decode_step(params: Dict, tokens: torch.Tensor, states: Dict,
                   pos: torch.Tensor, cfg: ModelConfig, *, precomputed=None,
                   n_valid: Optional[torch.Tensor] = None,
                   return_hidden: bool = False,
                   fused_gather_rope: bool = False, attn_backend=None
                   ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, T), pos (B,) -> (logits (B, T, V), states).

    ``n_valid is None`` is the one-token step (T == 1); with ``n_valid``
    (B,) the whole chunk advances in one call: slot b's tokens sit at
    ``pos[b] .. pos[b] + n_valid[b] - 1``, later lanes are padding (never
    written to a cache; their outputs are garbage). With ``precomputed``
    the embedding read and layer 0's projections are one row gather per
    token; ``fused_gather_rope`` (chunked path) also rotates layer 0's q/k
    inside that gather. ``return_hidden`` skips the final norm and head.
    """
    rope_applied = False
    if precomputed is not None:
        if n_valid is not None and fused_gather_rope \
                and fused_rope_eligible(precomputed, cfg):
            T = tokens.shape[1]
            pos_t = pos[:, None].long() + torch.arange(T, device=pos.device)
            pre0 = _fused_gather_rope_pre0(precomputed, tokens, pos_t, cfg)
            rope_applied = True
        else:
            pre0 = precomputed.gather(tokens)
        h = pre0['x']
    else:
        pre0 = None
        h = embed_tokens(params, tokens, cfg)
    h, states = backbone_decode(params['backbone'], h, states, pos, cfg,
                                pre0=pre0, n_valid=n_valid,
                                rope_applied=rope_applied,
                                attn_backend=attn_backend)
    return (h if return_hidden else lm_logits(params, h, cfg)), states


def fused_rope_eligible(precomputed, cfg: ModelConfig) -> bool:
    """Can layer 0's row gather fold RoPE in? True for rope-positional
    attention-first stacks whose row carries the flat q/k layout."""
    if precomputed is None or cfg.pos != 'rope' or cfg.mla is not None:
        return False
    if layer_plan(cfg).kinds[0] not in ATTN_KINDS:
        return False
    names = [nm for nm, _ in precomputed.layout]
    return 'q' in names and 'k' in names


def _fused_gather_rope_pre0(precomputed, tokens: torch.Tensor,
                            pos_t: torch.Tensor,
                            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Layer-0 rows via the fused gather→RoPE kernel: one table read per
    token with the q and k slices already rotated for their positions."""
    from repro_torch.kernels.gather_rope import gather_rope
    assert fused_rope_eligible(precomputed, cfg)
    offs, off = {}, 0
    for nm, w in precomputed.layout:
        offs[nm] = off
        off += w
    theta = kind_theta(cfg, layer_plan(cfg).kinds[0])
    hd = cfg.head_dim
    segs = ((offs['q'], cfg.num_heads, hd), (offs['k'], cfg.num_kv_heads, hd))
    rows = gather_rope(precomputed.table,
                       tokens.reshape(-1).to(torch.int32).contiguous(),
                       pos_t.reshape(-1).to(torch.int32).contiguous(),
                       segs=segs, theta=theta)
    return precomputed.split(rows.reshape(tuple(tokens.shape) + (-1,)))
