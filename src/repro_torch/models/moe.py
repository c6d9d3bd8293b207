"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro/models/moe.py``: routing, capacity, lane masks, the packed-prefill
``lane_order``, the drop count and the Switch-style load-balance loss,
which only the full-sequence forward asks for).

Tokens are routed to their top-k experts, the (token, k) slots are
stable-sorted by expert, each slot's position within its expert comes from
an exclusive cumsum of the expert counts, and slots past the expert
``capacity`` are dropped. The kept tokens fill an (E, C, d) buffer, the
experts run as three batched products (SwiGLU), and each token's output is
the router-weighted sum over its k slots.

Router modes:
- ``'topk_softmax'`` (Mixtral): top-k logits, softmax over them.
- ``'softmax_topk'`` (DeepSeek): softmax over all experts, top-k,
  renormalise.

Shared experts (DeepSeek) are a dense always-on SwiGLU of width
``num_shared * d_ff_expert``.

Unlike JAX's scatter-add over the sorted slots, a token's k outputs are
summed in its own top-k order: a fixed order on any device (no atomics),
so a token's output does not depend on which other tokens share the step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.models import layers as L
from repro_torch.models.ffn import ffn_apply, ffn_schema


def moe_schema(cfg: ModelConfig) -> Dict:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    sch = {
        'router': L.ParamSpec((d, E), 'fan_in', dtype='float32'),
        'w_up': L.ParamSpec((E, d, f)),
        'w_gate': L.ParamSpec((E, d, f)),
        'w_down': L.ParamSpec((E, f, d)),
    }
    if m.num_shared:
        sch['shared'] = ffn_schema(d, m.num_shared * f, glu=True)
    return sch


def capacity(num_tokens: int, m: MoEConfig) -> int:
    c = math.ceil(num_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)        # round up to a multiple of 8


def router_probs(logits: torch.Tensor, m: MoEConfig, mode: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (N, E) fp32 -> (weights (N, k), expert ids (N, k)), both in
    descending order of the router's preference. Among tied values
    ``torch.topk``'s order need not be ``lax.top_k``'s."""
    if mode == 'topk_softmax':
        top, idx = torch.topk(logits, m.top_k, dim=-1)
        return torch.softmax(top, dim=-1), idx
    if mode != 'softmax_topk':
        raise ValueError(f'unknown router mode {mode!r}')
    top, idx = torch.topk(torch.softmax(logits, dim=-1), m.top_k, dim=-1)
    return top / top.sum(dim=-1, keepdim=True), idx


def load_balance_loss(logits: torch.Tensor, counts: torch.Tensor, k: int,
                      lane_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Switch-style aux loss ``E * sum_e(mean router prob_e * slot
    fraction_e)`` from the router logits (N, E) and the per-expert slot
    counts (E,) of the real lanes, as JAX's ``moe_apply``: with a lane mask
    both means run over the real lanes only (at least one)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    if lane_mask is None:
        nv = float(logits.shape[0])
        p_mean = probs.mean(dim=0)
    else:
        valid = lane_mask.reshape(-1, 1).float()
        nv = valid.sum().clamp(min=1.0)
        p_mean = (probs * valid).sum(dim=0) / nv
    frac = counts.float() / (nv * k)
    return E * (p_mean * frac).sum()


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              router_mode: str = 'topk_softmax',
              lane_mask: Optional[torch.Tensor] = None,
              capacity_tokens: Optional[int] = None,
              lane_order: Optional[torch.Tensor] = None,
              with_aux: bool = False) -> Tuple[torch.Tensor, ...]:
    """x (B, S, d) -> (y (B, S, d), dropped_token_slots (int32 scalar
    tensor, on x's device)); ``with_aux`` -> (y, aux loss (float32 scalar,
    :func:`load_balance_loss`), dropped_token_slots), JAX's order. JAX
    computes the loss in every call and XLA drops it where unused; here
    only the full-sequence forward asks for it, so a decode step runs none
    of its work.

    ``lane_mask`` (B, S) bool marks real tokens: masked lanes (chunk
    padding, free slots) route to the null expert ``E``, which sorts last
    and never takes capacity, so they cannot displace a real token; their
    output rows are the shared experts' alone. ``capacity_tokens``
    overrides the token count the capacity is derived from: segment-packed
    prefill passes the slot-major count, so its denser (R, T) grid gets the
    capacity of the unpacked (S, T) grid. ``lane_order`` (B, S) int32 gives
    each lane a canonical token index (serving passes ``slot * T +
    local``): the dispatch sort then orders ties within an expert by it
    instead of by grid position, so packed and unpacked grids route and drop
    real tokens in the same order. ``None`` keeps the stable sort by grid
    position, the same order whenever the grid is slot-major.
    ``dropped_token_slots`` counts the (token, k) slots of real tokens that
    overflowed their expert's capacity.
    """
    m = cfg.moe
    B, S, d = x.shape
    N = B * S
    k, E = m.top_k, m.num_experts
    dev = x.device
    xf = x.reshape(N, d)
    logits = xf.float() @ params['router'].float()
    w, idx = router_probs(logits, m, router_mode)               # (N, k)
    ef = idx.reshape(N * k)                                     # expert/slot
    if lane_mask is not None:
        live = lane_mask.reshape(N).repeat_interleave(k)
        ef = torch.where(live, ef, torch.full_like(ef, E))

    C = capacity(N if capacity_tokens is None else capacity_tokens, m)
    if lane_order is None:
        order = torch.argsort(ef, stable=True)
    else:
        # composite key (expert, canonical slot index): slotc < M, so the
        # sort is by expert first, canonical order within an expert
        canon = lane_order.reshape(N).long()
        slotc = (canon[:, None] * k
                 + torch.arange(k, device=dev)[None]).reshape(N * k)
        M = (N if capacity_tokens is None else capacity_tokens) * k
        order = torch.argsort(ef.long() * M + slotc, stable=True)
    e_s = ef[order]
    t_s = torch.div(order, k, rounding_mode='floor')            # token/slot
    # per-expert slot counts (the null expert's dropped); not bincount,
    # which reads its input's max back to the host on a CUDA device
    counts = ef.new_zeros(E + 1).index_add_(0, ef, torch.ones_like(ef))[:E]
    starts = torch.cumsum(counts, 0) - counts                   # exclusive
    e_g = e_s.clamp(max=E - 1)
    slot_pos = torch.arange(N * k, device=dev) - starts[e_g]    # in expert
    ok = e_s < E
    dropped = (ok & (slot_pos >= C)).sum().to(torch.int32)
    keep = ok & (slot_pos < C)
    slot_pos = torch.where(keep, slot_pos, torch.full_like(slot_pos, C))

    # row C of each expert collects the dropped and null slots: junk that
    # the products below never read
    buf = x.new_zeros((E, C + 1, d))
    buf.view(E * (C + 1), d)[e_g * (C + 1) + slot_pos] = xf[t_s]
    buf = buf[:, :C]
    up = torch.bmm(buf, params['w_up'])
    gate = F.silu(torch.bmm(buf, params['w_gate']))
    y_e = torch.bmm(gate * up, params['w_down'])                # (E, C, d)

    vals = y_e[e_g, slot_pos.clamp(max=C - 1)] \
        * w.reshape(N * k).to(x.dtype)[order][:, None]
    vals = torch.where(keep[:, None], vals, torch.zeros((), dtype=x.dtype,
                                                        device=dev))
    per_slot = torch.empty_like(vals)
    per_slot[order] = vals                         # back to (token, k) order
    y = per_slot.view(N, k, d).sum(dim=1)
    if 'shared' in params:
        y = y + ffn_apply(params['shared'], xf, act='silu')
    if with_aux:
        aux = load_balance_loss(logits, counts, k, lane_mask)
        return y.reshape(B, S, d), aux, dropped
    return y.reshape(B, S, d), dropped


def moe_num_weights(cfg: ModelConfig) -> int:
    m = cfg.moe
    n = 3 * cfg.d_model * m.d_ff_expert * m.num_experts
    if m.num_shared:
        n += 3 * cfg.d_model * m.d_ff_expert * m.num_shared
    return n
