"""Token sampling: greedy / temperature / top-k, batched (port of
``repro/serving/sampler.py``). Greedy picks equal JAX's (first index on
ties); sampled picks draw from a ``torch.Generator`` (Gumbel-max), so they
follow the same distribution as JAX's but not its numbers."""
from __future__ import annotations

import torch


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """logits (B, V); temperature (B,) — 0 means greedy for that row.
    -> (B,) int32 tokens."""
    lf = logits.float()
    if top_k:
        # keep exactly k candidates even when the kth logit is tied
        k = min(int(top_k), lf.shape[-1])
        vals, idx = torch.topk(lf, k, dim=-1)
        lf = torch.full_like(lf, float('-inf')).scatter(-1, idx, vals)
    greedy = torch.argmax(lf, dim=-1)
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = torch.argmax(lf / temp + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
