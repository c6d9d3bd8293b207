"""THE PAPER: offline precomputation of the first transformer layer (port of
``repro/core/precompute.py`` for the serial block).

For every vocabulary entry, run layer 0's position-independent part (first
norm, Q/K/V projections) and store the results as an expanded embedding
table with rows ``[x, q, k, v]`` (width d + q_size + 2e; 10240 for
mistral-7b). At serving time the embedding read and those projections
collapse into one row gather per token (:meth:`PrecomputedTable.gather`),
which on a CUDA device is the ``embed_gather`` kernel. RoPE and attention
stay at run time — the enabling condition.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.embed_gather import embed_gather
from repro_torch.models.blocks import block_preproj, preproj_layout
from repro_torch.models.transformer import layer_plan


@dataclasses.dataclass
class PrecomputedTable:
    """Expanded embedding table ``(vocab, row_width)`` + its row layout
    ``((name, width), ...)`` in storage order."""
    table: torch.Tensor
    layout: Tuple[Tuple[str, int], ...]
    name: str = ''

    def split(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for nm, w in self.layout:
            out[nm] = rows[..., off:off + w]
            off += w
        return out

    def gather(self, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The paper's one memory read per token: tokens (...) -> named
        row pieces (..., width)."""
        flat = tokens.reshape(-1).to(torch.int32).contiguous()
        rows = embed_gather(self.table, flat)
        return self.split(rows.reshape(tuple(tokens.shape) + (-1,)))


@torch.no_grad()
def build_precomputed_table(params: Dict, cfg: ModelConfig, *,
                            chunk: int = 8192) -> PrecomputedTable:
    """Offline pass: run the whole vocabulary through layer 0's
    position-independent computation, ``chunk`` rows at a time."""
    assert cfg.precompute_supported, (
        f'{cfg.name}: position encoding "{cfg.pos}" is applied before the '
        'projections — the paper\'s precondition does not hold')
    plan = layer_plan(cfg)
    kind0, moe0 = plan.kinds[0], plan.use_moe[0]
    layout = preproj_layout(cfg, kind0, moe0)
    embed = params['embed']['table']
    dtype = getattr(torch, cfg.dtype)
    rows = []
    for s in range(0, embed.shape[0], chunk):
        x = embed[s:s + chunk].to(dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        pieces = block_preproj(params['backbone']['layer0'], x[None], cfg,
                               kind0, moe0)
        rows.append(torch.cat([pieces[nm].to(dtype) for nm, _ in layout],
                              dim=-1)[0])
    return PrecomputedTable(torch.cat(rows, dim=0).contiguous(), layout,
                            cfg.name)
