"""THE PAPER: offline precomputation of the first transformer layer (port of
``repro/core/precompute.py`` for the serial and the parallel block).

For every vocabulary entry, run layer 0's position-independent part (first
norm, Q/K/V projections) and store the results as an expanded embedding
table with rows ``[x, q, k, v]`` (width d + q_size + 2e; 10240 for
mistral-7b), or ``[x, q, c_kv, k_pe]`` for MLA (d + H·(dn + dr) + r + dr;
5696 for deepseek-v2-lite-16b), as ``blocks.preproj_layout`` lays out. A
parallel block (pythia-6.9b) also runs LN2, the FFN and the skip for every
row: ``[s, q, k, v]`` with ``s = x + FFN(LN2(x))``, 16384 wide (d + 3 x
4096), so layer 0 keeps only its attention at run time; in a parallel MoE
block (mixtral-8x7b-parallel, the paper's §3 third column) that FFN is
the whole expert FFN, run over each ``chunk`` of rows without a lane mask
as JAX runs it, so the capacity is ``capacity(chunk)`` and rows past it
drop exactly as in JAX's table (``return_drops`` counts them). No step
here differs by block type, ``blocks.block_preproj`` does. At serving time
the embedding read and those projections collapse into one row gather per
token (:meth:`PrecomputedTable.gather`), which on a CUDA device is the
``embed_gather`` kernel. RoPE and attention stay at run time — the
enabling condition. A VLM gathers rows for its text positions only and
computes its patches' pieces on the fly (:func:`hybrid_vlm_pre0`).
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
                            chunk: int = 8192, return_drops: bool = False):
    """Offline pass: run the whole vocabulary through layer 0's
    position-independent computation, ``chunk`` rows at a time (JAX's
    chunk: the parallel MoE's capacity depends on it). ``return_drops`` ->
    (table, MoE token slots dropped over the build: an int, zero unless
    layer 0 is a parallel MoE block)."""
    assert cfg.precompute_supported, (
        f'{cfg.name}: position encoding "{cfg.pos}" is applied before the '
        'projections — the paper\'s precondition does not hold')
    plan = layer_plan(cfg)
    kind0, moe0 = plan.kinds[0], plan.use_moe[0]
    layout = preproj_layout(cfg, kind0, moe0)
    embed = params['embed']['table']
    dtype = getattr(torch, cfg.dtype)
    # written chunk by chunk into its place: the peak is one table, not two
    rows = torch.empty((embed.shape[0], sum(w for _, w in layout)),
                       dtype=dtype, device=embed.device)
    drops = 0
    for s in range(0, embed.shape[0], chunk):
        x = embed[s:s + chunk].to(dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        pieces, d = block_preproj(params['backbone']['layer0'], x[None],
                                  cfg, kind0, moe0, return_drops=True)
        off = 0
        for nm, w in layout:
            rows[s:s + chunk, off:off + w] = pieces[nm][0]
            off += w
        drops = drops + d
    table = PrecomputedTable(rows, layout, cfg.name)
    return (table, int(drops)) if return_drops else table


def hybrid_vlm_pre0(params: Dict, cfg: ModelConfig, table: PrecomputedTable,
                    tokens: torch.Tensor, vision_h: torch.Tensor,
                    n_prefix: int) -> Dict[str, torch.Tensor]:
    """The VLM's *hybrid* mode: table rows for the text tokens (one
    ``embed_gather``), layer 0's norm and projections on the fly for the
    (continuous) vision embeddings (``block_preproj``), and each named
    piece spliced as ``[text_prefix | vision | text_suffix]``."""
    plan = layer_plan(cfg)
    pre_txt = table.gather(tokens)
    vpre = block_preproj(params['backbone']['layer0'], vision_h, cfg,
                         plan.kinds[0], plan.use_moe[0])
    out = {}
    for nm, _ in table.layout:
        t = pre_txt[nm]
        out[nm] = torch.cat([t[:, :n_prefix], vpre[nm].to(t.dtype),
                             t[:, n_prefix:]], dim=1)
    return out
