"""Attention backends for every decode/chunk attend (port of
``repro/models/attn_backend.py``, dense caches only).

- ``'reference'``: plain PyTorch, query lanes one at a time
  (``attention.decode_attend_chunk``), as the JAX reference backend.
- ``'cuda'``: the hand-written ``paged_attention`` kernel
  (``kernels/paged_attention.py``). A dense (B, Sc, ...) cache is viewed,
  without a copy, as identity-table pages; all T query lanes of a chunk go
  in one launch. On CPU tensors the kernel wrapper runs its plain version,
  so the backend's plumbing is testable without a card.
- ``'auto'`` resolves by device: ``cuda`` for a CUDA device, ``reference``
  for the CPU. (JAX's ``'auto'`` picks the plain path everywhere except on
  a TPU; here the kernel is the default wherever it runs.)

Parity: ``cuda`` matches ``reference`` within :data:`KERNEL_TOL` (the JAX
package's ``PALLAS_TOL``, fp32 running-softmax reassociation).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

# accuracy bound of the kernel backend's attend outputs vs the reference
KERNEL_TOL = dict(atol=2e-4, rtol=2e-4)


class AttnBackend:
    """Produce attend context from the stored (already updated) cache."""

    name = 'abstract'

    def attend_chunk(self, q: torch.Tensor, cache: Dict, pos0: torch.Tensor,
                     cfg: ModelConfig, *, rope_theta: float, window: int = 0,
                     rope_applied: bool = False) -> torch.Tensor:
        """q (B, T, q_size) flat (pre-RoPE unless ``rope_applied``); lane t
        sits at ``pos0 + t``. -> (B, T, H*hd) context."""
        raise NotImplementedError


class ReferenceBackend(AttnBackend):
    name = 'reference'

    def attend_chunk(self, q, cache, pos0, cfg, *, rope_theta, window=0,
                     rope_applied=False):
        from repro_torch.models import attention as A
        return A.decode_attend_chunk(q, cache, pos0, cfg,
                                     rope_theta=rope_theta, window=window,
                                     rope_applied=rope_applied)


class CudaBackend(AttnBackend):
    name = 'cuda'

    def attend_chunk(self, q, cache, pos0, cfg, *, rope_theta, window=0,
                     rope_applied=False):
        from repro_torch.kernels.paged_attention import (dense_as_pages,
                                                         dense_identity_table,
                                                         dense_page_split,
                                                         paged_attention)
        B, T = q.shape[0], q.shape[1]
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = q.reshape(B, T, H, hd)
        if cfg.pos == 'rope' and not rope_applied:
            pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
            q = L.apply_rope(q, pos_t, rope_theta)
        k = cache['k']
        # the kernel reads q, K and V in one dtype: queries follow the cache
        qg = q.reshape(B, T, KV, H // KV, hd).to(k.dtype).contiguous()
        Sc = k.shape[1]
        ps = dense_page_split(Sc)
        ctx = paged_attention(
            qg, dense_as_pages(k, ps), dense_as_pages(cache['v'], ps),
            dense_as_pages(cache['pos'], ps),
            dense_identity_table(B, Sc, ps, q.device),
            pos0.to(torch.int32).contiguous(), scale=hd ** -0.5,
            window=window)
        return ctx.reshape(B, T, H * hd).to(q.dtype)


REFERENCE = ReferenceBackend()
CUDA = CudaBackend()
BACKENDS = {b.name: b for b in (REFERENCE, CUDA)}


def get_backend(backend: Optional['str | AttnBackend'],
                device: torch.device | str = 'cpu') -> AttnBackend:
    """None -> reference; 'auto' -> by ``device`` (cuda kernel on a CUDA
    device, reference on the CPU); a name -> the singleton; an instance
    passes."""
    if backend is None:
        return REFERENCE
    if isinstance(backend, AttnBackend):
        return backend
    if backend == 'auto':
        return CUDA if torch.device(device).type == 'cuda' else REFERENCE
    try:
        return BACKENDS[backend]
    except KeyError:
        raise ValueError(f'unknown attention backend {backend!r}; '
                         f"choose from {sorted(BACKENDS) + ['auto']}") \
            from None
