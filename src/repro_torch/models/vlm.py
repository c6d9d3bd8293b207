"""InternVL-style VLM (port of ``repro/models/vlm.py``): vision stub -> MLP
projector -> language model.

The ViT (InternViT) is a stub, as in JAX: the caller hands precomputed patch
features (B, n_patches, frontend_dim). The projector (the config's norm over
``frontend_dim``, then ``fc1`` and ``fc2`` with biases and a GELU between)
and the language backbone are real.

Sequence layout: ``[text_prefix | image patches | text_suffix]``, with the
split ``n_prefix`` fixed per call (``Model`` passes ``VLM_PREFIX``).

Paper relevance, the *hybrid* mode: patch embeddings are continuous (not
enumerable), so only text positions gather table rows; the patches run
layer 0's norm and projections on the fly
(``core.precompute.hybrid_vlm_pre0``), and the saving scales with the text
fraction. Decode after the multimodal prefill is the plain LM's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (backbone_apply, embed_tokens,
                                            lm_decode_step, lm_head)


def vlm_schema(cfg: ModelConfig) -> Dict:
    from repro_torch.params import lm_schema
    e = cfg.encoder
    sch = lm_schema(cfg)
    sch['projector'] = {
        'ln': L.norm_schema(e.frontend_dim, cfg.norm),
        'fc1': L.dense_schema(e.frontend_dim, cfg.d_model, bias=True),
        'fc2': L.dense_schema(cfg.d_model, cfg.d_model, bias=True),
    }
    return sch


def project_patches(params: Dict, patches: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """(B, P, frontend_dim) stub ViT features -> (B, P, d_model)."""
    pr = params['projector']
    h = L.norm_apply(pr['ln'], patches.to(getattr(torch, cfg.dtype)),
                     cfg.norm)
    h = L.activation('gelu')(L.dense(pr['fc1'], h))
    return L.dense(pr['fc2'], h)


@torch.no_grad()
def vlm_apply(params: Dict, tokens: torch.Tensor, patches: torch.Tensor,
              cfg: ModelConfig, *, n_prefix: int = 0, precomputed=None,
              return_hidden: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S_text), patches (B, P, fd) -> (logits over the FULL
    sequence (B, S_text + P, V), aux). The patches sit at ``[n_prefix,
    n_prefix + P)``; their logits are produced but mean nothing. With
    ``precomputed`` layer 0 takes the hybrid rows
    (``core.precompute.hybrid_vlm_pre0``)."""
    B, S_text = tokens.shape
    S = S_text + patches.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    vis_h = project_patches(params, patches, cfg)
    if precomputed is not None:
        from repro_torch.core.precompute import hybrid_vlm_pre0
        pre0 = hybrid_vlm_pre0(params, cfg, precomputed, tokens, vis_h,
                               n_prefix)
        h = pre0['x']
    else:
        pre0 = None
        txt = embed_tokens(params, tokens, cfg, positions[:, :S_text])
        h = torch.cat([txt[:, :n_prefix], vis_h.to(txt.dtype),
                       txt[:, n_prefix:]], dim=1)
    h, aux = backbone_apply(params['backbone'], h, positions, cfg, pre0=pre0)
    h = L.norm_apply(params['final_norm'], h, cfg.norm)
    if return_hidden:
        return h, aux
    return lm_head(params, h, cfg), aux


# decode after the multimodal prefill is the plain LM's
vlm_decode_step = lm_decode_step
