"""Model facade (port of ``repro/models/model.py``): ``init`` / ``apply`` /
``decode_step`` / ``make_states`` / ``build_table``, dispatching on
``cfg.arch_class`` as JAX does: the decoder-only LM classes ``'dense'``,
``'moe'``, ``'ssm'`` (xLSTM's mLSTM / sLSTM blocks) and ``'hybrid'``
(Hymba: attention beside mamba heads, with learnable meta tokens that
lead every sequence: :func:`transformer.prime_meta_states` primes decode
states with them), the encoder-decoder ``'audio'`` (``models/encdec.py``;
decode is one token a step on dense caches with the reference attention
backend) and ``'vlm'`` (``models/vlm.py``; ``apply`` reads
``batch['patches']``, decode is the plain LM's). Which layer kinds and
block structures are ported is decided in ``models/blocks.py``, which
raises for the rest."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import params as PR
from repro_torch.config import ModelConfig
from repro_torch.core import precompute as PC
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V

VLM_PREFIX = 16          # static text-prefix length before the image span
PORTED_CLASSES = ('dense', 'moe', 'ssm', 'hybrid', 'audio', 'vlm')


def audio_backend(attn_backend, device):
    """The attention backend of an enc-dec decode: ``'auto'`` (and None)
    resolve to ``reference`` on every device, as JAX's ``'auto'`` does on
    every platform but a TPU; anything else that is not the reference
    raises ``ValueError``, as JAX's ``'pallas'`` does."""
    from repro_torch.models.attn_backend import REFERENCE, get_backend
    backend = REFERENCE if attn_backend in (None, 'auto') \
        else get_backend(attn_backend, device)
    if backend.name != 'reference':
        raise ValueError('audio enc-dec decode supports only the '
                         'reference attention backend')
    return backend


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.arch_class not in PORTED_CLASSES:
            raise NotImplementedError(
                f'arch_class {self.cfg.arch_class!r} is not ported yet '
                f'(ported: {PORTED_CLASSES})')

    def init(self, seed: int = 0, device: torch.device | str = 'cuda',
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights made on ``device`` from a seeded generator."""
        return PR.init_params(self.cfg, seed, device, dtype)

    @torch.no_grad()
    def apply(self, params: Dict, batch: Dict[str, torch.Tensor], *,
              precomputed=None, return_hidden: bool = False):
        """The full-sequence forward: ``batch['tokens']`` (B, S) -> (logits
        (B, S, V), aux loss, a float32 scalar on the tokens' device: the
        MoE load-balance loss summed over the MoE layers, zero without
        them). With ``precomputed`` (``build_table``) layer 0 reads table
        rows instead of running its norm and projections; the logits equal
        the baseline's (the paper's contract). GQA or MLA attention with a
        dense or MoE FFN, serial or parallel (a parallel table row also
        carries layer 0's FFN, the whole expert FFN for a parallel MoE, and
        its skip: layer 0's MoE, and its aux loss, then drop out). An
        audio model also reads ``batch['frames']`` (B, T, frontend_dim)
        and a VLM ``batch['patches']`` (B, P, frontend_dim), spliced after
        ``VLM_PREFIX`` text tokens (its logits cover the whole sequence;
        its table is the hybrid one)."""
        c = self.cfg
        if c.arch_class == 'audio':
            return E.encdec_apply(params, batch['tokens'], batch['frames'],
                                  c, precomputed=precomputed,
                                  return_hidden=return_hidden)
        if c.arch_class == 'vlm':
            return V.vlm_apply(params, batch['tokens'], batch['patches'], c,
                               n_prefix=VLM_PREFIX, precomputed=precomputed,
                               return_hidden=return_hidden)
        return T.lm_apply(params, batch['tokens'], c,
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
        (``transformer.lm_decode_step``).

        Audio (enc-dec) decode is one token a step on dense caches only
        (``n_valid``, ``paged`` and ``packed`` must be None) with the
        reference backend (:func:`audio_backend`: ``'auto'`` resolves to
        it, ``'cuda'`` raises ``ValueError``); ``return_stats`` gives zero
        drops (no MoE in the enc-dec stack)."""
        from repro_torch.models.attn_backend import get_backend
        if self.cfg.arch_class == 'audio':
            assert n_valid is None and paged is None and packed is None, \
                'audio decode is one token per step, dense cache only'
            audio_backend(attn_backend, tokens.device)
            logits, states = E.encdec_decode_step(params, tokens, states,
                                                  pos, self.cfg,
                                                  precomputed=precomputed)
            if return_stats:
                return logits, states, {'moe_drops': torch.zeros(
                    (), dtype=torch.int32, device=logits.device)}
            return logits, states
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
        scales (MLA latent caches stay in ``dtype``). Audio: the self
        caches and zeroed cross K/V (``encdec.encdec_make_states``; dense
        only; ``chunk`` and ``kv_quant`` are ignored, as in JAX)."""
        if self.cfg.arch_class == 'audio':
            assert not num_pages, 'paged KV is not supported for audio'
            return E.encdec_make_states(self.cfg, batch, seq_len, dtype,
                                        device)
        return T.backbone_make_states(self.cfg, batch, seq_len, dtype, chunk,
                                      device, num_pages, page_size, kv_quant)

    def paged_state_mask(self, kv_quant: bool = False) -> Dict:
        """Bool tree matching paged ``make_states``: True on page-pool
        leaves, False on per-slot state."""
        assert self.cfg.arch_class != 'audio'
        return T.backbone_paged_mask(self.cfg, kv_quant)

    def build_table(self, params: Dict) -> PC.PrecomputedTable:
        return PC.build_precomputed_table(params, self.cfg)
