"""Token sampling: greedy / temperature / top-k, batched (port of
``repro/serving/sampler.py``). Greedy picks equal JAX's (first index on
ties); sampled picks draw from a ``torch.Generator`` (Gumbel-max), so they
follow the same distribution as JAX's but not its numbers."""
from __future__ import annotations

from typing import Optional

import torch


def sample_tokens(logits: torch.Tensor,
                  generator: Optional[torch.Generator],
                  temperature: torch.Tensor, top_k: int = 0,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V); temperature (B,) — 0 means greedy for that row.
    ``noise`` (B, V) float32 uniforms in [0, 1) stand in for the draw from
    ``generator`` (the engine's programs draw them outside a CUDA graph,
    into a static buffer). -> (B,) int32 tokens."""
    lf = logits.float()
    if top_k:
        # keep exactly k candidates even when the kth logit is tied
        k = min(int(top_k), lf.shape[-1])
        vals, idx = torch.topk(lf, k, dim=-1)
        lf = torch.full_like(lf, float('-inf')).scatter(-1, idx, vals)
    greedy = torch.argmax(lf, dim=-1)
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    u = noise if noise is not None else \
        torch.rand(lf.shape, generator=generator, device=lf.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = torch.argmax(lf / temp + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
