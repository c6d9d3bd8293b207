"""Model facade (port of ``repro/models/model.py`` for ``arch_class ==
'dense'``): ``init`` / ``decode_step`` / ``make_states`` / ``build_table``.
Other families raise ``NotImplementedError`` until they are ported."""
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
        if self.cfg.arch_class != 'dense':
            raise NotImplementedError(
                f'arch_class {self.cfg.arch_class!r} is not ported yet '
                "(the port serves 'dense' models)")

    def init(self, seed: int = 0, device: torch.device | str = 'cuda',
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights made on ``device`` from a seeded generator."""
        return PR.init_params(self.cfg, seed, device, dtype)

    @torch.no_grad()
    def decode_step(self, params: Dict, tokens: torch.Tensor, states: Dict,
                    pos: torch.Tensor, *, precomputed=None, n_valid=None,
                    return_hidden: bool = False,
                    fused_gather_rope: bool = False, attn_backend='auto'):
        """tokens (B, T), pos (B,) -> (logits (B, T, V), states). T == 1
        with ``n_valid=None`` is the one-token step; ``n_valid`` (B,) runs
        the chunked-prefill path. Caches update in place. ``attn_backend``
        ('auto' | 'reference' | 'cuda' | an AttnBackend) picks the attend."""
        from repro_torch.models.attn_backend import get_backend
        backend = get_backend(attn_backend, tokens.device)
        return T.lm_decode_step(params, tokens, states, pos, self.cfg,
                                precomputed=precomputed, n_valid=n_valid,
                                return_hidden=return_hidden,
                                fused_gather_rope=fused_gather_rope,
                                attn_backend=backend)

    def make_states(self, batch: int, seq_len: int,
                    dtype: torch.dtype = torch.bfloat16, chunk: int = 1,
                    device: torch.device | str = 'cuda') -> Dict:
        return T.backbone_make_states(self.cfg, batch, seq_len, dtype, chunk,
                                      device)

    def build_table(self, params: Dict) -> PC.PrecomputedTable:
        return PC.build_precomputed_table(params, self.cfg)
