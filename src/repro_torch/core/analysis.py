"""Paper §3 analysis: weight counts, memory-read savings, memory-size deltas
(a copy of ``repro/core/analysis.py``, pure Python on the port's configs,
``blocks.preproj_layout`` and ``transformer.layer_plan``).

Implements the exact accounting of the paper's two tables so the benchmark can
assert against the published numbers (Pythia-6.9B, Mistral-7B, hypothetical
parallel Mixtral-8x7B):

  reads without precompute (batch B) = B·d + |W_{Q,K,V[,FFN]}|
  reads with precompute    (batch B) = B·row_width           (= B·2(d+e))
  table growth = (row_width − d) · vocab  (= (2e+d)·vocab when q_size=d)
  net memory delta = table growth − eliminated weights

The paper counts scalar *elements*; bytes are elements times the table's
dtype size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.config import ModelConfig
from repro_torch.models.blocks import preproj_layout
from repro_torch.models.transformer import layer_plan


@dataclasses.dataclass
class WeightCounts:
    q_p_per_layer: int          # Q + post-projection P   (2·d·d for MHA)
    k_v_per_layer: int          # K + V                    (2·d·e)
    ffn_per_layer: int          # (2 or 3)·d·hidden·n_experts
    embed: int                  # input+output embeddings
    total: int

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def weight_counts(cfg: ModelConfig) -> WeightCounts:
    d = cfg.d_model
    q_p = d * cfg.q_size + cfg.attn_out_size * d
    k_v = 2 * d * cfg.kv_size
    if cfg.moe:
        ffn = (3 if cfg.glu else 2) * d * cfg.moe.d_ff_expert \
            * cfg.moe.num_experts
    else:
        ffn = (3 if cfg.glu else 2) * d * cfg.d_ff
    embed = (1 if cfg.tie_embeddings else 2) * d * cfg.vocab_size
    total = embed + cfg.num_layers * (q_p + k_v + ffn)
    return WeightCounts(q_p, k_v, ffn, embed, total)


@dataclasses.dataclass
class PrecomputeAnalysis:
    name: str
    row_width: int              # precomputed values per token (2(d+e) classic)
    eliminated_weights: int     # weights no longer read/stored for layer 0
    table_growth: int           # extra embedding-table elements
    net_memory_delta: int       # table_growth - eliminated_weights
    rel_memory_delta: float     # vs total weights
    reads_without_b1: int
    reads_with_b1: int

    def reads_without(self, batch: int, cfg_d: int) -> int:
        return batch * cfg_d + self.eliminated_weights

    def reads_with(self, batch: int) -> int:
        return batch * self.row_width

    def reduction_factor(self, batch: int, cfg_d: int) -> float:
        return self.reads_without(batch, cfg_d) / self.reads_with(batch)


def eliminated_weights(cfg: ModelConfig) -> int:
    """Layer-0 weights whose reads (and storage) precompute removes."""
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        n = d * cfg.q_size + d * (m.kv_lora_rank + m.qk_rope_dim)
        if m.q_lora_rank:
            n = d * m.q_lora_rank + m.q_lora_rank * cfg.q_size \
                + d * (m.kv_lora_rank + m.qk_rope_dim)
        return n
    plan = layer_plan(cfg)
    kind0, moe0 = plan.kinds[0], plan.use_moe[0]
    if kind0 == 'mlstm':
        ed = cfg.ssm.expand * d
        return d * 2 * ed + ed * ed + ed * 2 * cfg.ssm.num_ssm_heads  # up,v,if
    if kind0 == 'slstm':
        return 2 * d * d                                     # w_z + w_o
    n = d * cfg.q_size + 2 * d * cfg.kv_size                 # Q, K, V
    if kind0 in ('hybrid', 'hybrid_global'):
        ed = cfg.num_heads * cfg.head_dim
        return n + 2 * d * ed                                # + w_in, w_gate
    if cfg.block_type == 'parallel':
        wc = weight_counts(cfg)
        n += wc.ffn_per_layer
        if moe0 and cfg.moe and cfg.moe.num_shared:
            n += 3 * d * cfg.moe.d_ff_expert * cfg.moe.num_shared
    return n


def analyze(cfg: ModelConfig) -> PrecomputeAnalysis:
    plan = layer_plan(cfg)
    layout = preproj_layout(cfg, plan.kinds[0], plan.use_moe[0])
    row = sum(w for _, w in layout)
    elim = eliminated_weights(cfg)
    wc = weight_counts(cfg)
    growth = (row - cfg.d_model) * cfg.vocab_size
    net = growth - elim
    return PrecomputeAnalysis(
        name=cfg.name, row_width=row, eliminated_weights=elim,
        table_growth=growth, net_memory_delta=net,
        rel_memory_delta=net / wc.total,
        reads_without_b1=cfg.d_model + elim, reads_with_b1=row)


def max_relative_savings(cfg: ModelConfig) -> float:
    """Abstract's claim: savings bounded by 1/num_layers (4L -> 25%, 32L -> ~3%)."""
    return 1.0 / cfg.num_layers
