"""Model facade (port of ``repro/models/model.py`` for the decoder-only LM
classes ``'dense'`` and ``'moe'``): ``init`` / ``apply`` / ``decode_step``
/ ``make_states`` / ``build_table``. Other classes (audio, vlm, ssm, hybrid)
raise ``NotImplementedError``; which layer kinds and block structures are
ported is decided in ``models/blocks.py``, which raises for the rest."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import params as PR
from repro_torch.config import ModelConfig
from repro_torch.core import precompute as PC
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.arch_class not in ('dense', 'moe'):
            raise NotImplementedError(
                f'arch_class {self.cfg.arch_class!r} is not ported yet '
                "(the port serves the decoder-only 'dense' and 'moe' "
                'classes)')

    def init(self, seed: int = 0, device: torch.device | str = 'cuda',
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights made on ``device`` from a seeded generator."""
        return PR.init_params(self.cfg, seed, device, dtype)

    @torch.no_grad()
    def apply(self, params: Dict, batch: Dict[str, torch.Tensor], *,
              precomputed=None, return_hidden: bool = False):
        """The full-sequence forward: ``batch['tokens']`` (B, S) -> (logits
        (B, S, V), aux loss, a float32 scalar on the tokens' device). With
        ``precomputed`` (``build_table``) layer 0 reads table rows instead of
        running its norm and projections; the logits equal the baseline's
        (the paper's contract). GQA blocks with a dense FFN, serial or
        parallel (a parallel table row also carries layer 0's FFN and
        skip); MLA and MoE blocks raise ``NotImplementedError``."""
        return T.lm_apply(params, batch['tokens'], self.cfg,
                          precomputed=precomputed,
                          return_hidden=return_hidden)

    @torch.no_grad()
    def decode_step(self, params: Dict, tokens: torch.Tensor, states: Dict,
                    pos: torch.Tensor, *, precomputed=None, n_valid=None,
                    return_hidden: bool = False,
                    fused_gather_rope: bool = False, paged=None,
                    lane_valid=None, return_stats: bool = False,
                    attn_backend='auto', packed=None):
        """tokens (B, T), pos (B,) -> (logits (B, T, V), states). T == 1
        with ``n_valid=None`` is the one-token step; ``n_valid`` (B,) runs
        the chunked-prefill path. ``lane_valid`` (B,) bool masks free slots
        out of MoE routing in the one-token step; ``return_stats`` appends
        ``{'moe_drops': int32 tensor}``. ``paged`` (an ``attention.PageTables``)
        addresses the caches of paged states; a ``fused_maintenance``
        backend (``'cuda'``) needs its step job list
        (``PageTables.with_jobs``) and raises without it. Caches update in
        place.
        ``attn_backend`` ('auto' | 'reference' | 'cuda' | an AttnBackend)
        picks the attend. ``packed`` (an ``attention.PackedLayout``; with
        ``n_valid``) runs the segment-packed grid
        (``transformer.lm_decode_step``)."""
        from repro_torch.models.attn_backend import get_backend
        backend = get_backend(attn_backend, tokens.device)
        return T.lm_decode_step(params, tokens, states, pos, self.cfg,
                                precomputed=precomputed, n_valid=n_valid,
                                return_hidden=return_hidden,
                                fused_gather_rope=fused_gather_rope,
                                paged=paged, lane_valid=lane_valid,
                                return_stats=return_stats,
                                attn_backend=backend, packed=packed)

    def make_states(self, batch: int, seq_len: int,
                    dtype: torch.dtype = torch.bfloat16, chunk: int = 1,
                    device: torch.device | str = 'cuda', num_pages: int = 0,
                    page_size: int = 0, kv_quant: bool = False) -> Dict:
        """``num_pages > 0`` builds paged-KV storage: attention caches
        become a global (num_pages, page_size, ...) pool addressed through
        page tables. ``kv_quant``: int8 K/V with bf16 per-(token, head)
        scales (MLA latent caches stay in ``dtype``)."""
        return T.backbone_make_states(self.cfg, batch, seq_len, dtype, chunk,
                                      device, num_pages, page_size, kv_quant)

    def paged_state_mask(self, kv_quant: bool = False) -> Dict:
        """Bool tree matching paged ``make_states``: True on page-pool
        leaves, False on per-slot state."""
        return T.backbone_paged_mask(self.cfg, kv_quant)

    def build_table(self, params: Dict) -> PC.PrecomputedTable:
        return PC.build_precomputed_table(params, self.cfg)
