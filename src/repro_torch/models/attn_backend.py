"""Attention backends for every decode/chunk attend, GQA and MLA (port of
``repro/models/attn_backend.py`` for dense caches and the paged pool).

- ``'reference'``: plain PyTorch, query lanes one at a time
  (``attention.decode_attend_chunk``), as the JAX reference backend. Paged
  storage is first gathered into a dense-shaped view
  (``attention.paged_view``), so its contractions are the dense path's.
- ``'cuda'``: the hand-written ``paged_attention`` kernel
  (``kernels/paged_attention.py``). Pool pages are read in place through
  the slot's page table; a dense (B, Sc, ...) cache is viewed, without a
  copy, as identity-table pages. All T query lanes of a chunk go in one
  launch. int8 caches take the kernel's int8 form
  (``paged_attention_quant``) with the scale leaves, the queries in the
  model's dtype. MLA layers take the kernel's MLA form
  (``paged_attention_mla``) over the latent pages, with W_UK absorbed into
  the fp32 query. It declares ``fused_maintenance``: paged writes go
  through the ``fused_page_write`` job list with deferred clears, and the
  engine's copy-on-write through ``cow_page_copy``
  (``kernels/paged_maintenance.py``). On CPU tensors the kernel wrappers
  run their plain versions, so the backend's plumbing is testable without
  a card.
  ``CudaBackend(mesh)`` (not registered; the serving engine makes one
  under a device mesh) splits every chunk attend over the mesh's kv-head
  shards (``sharded_paged_attention``).
- ``'auto'`` resolves by device: ``cuda`` for a CUDA device, ``reference``
  for the CPU. (JAX's ``'auto'`` picks the plain path everywhere except on
  a TPU; here the kernel is the default wherever it runs.)

Parity: ``cuda`` matches ``reference`` within :data:`KERNEL_TOL` (the JAX
package's ``PALLAS_TOL``, fp32 running-softmax reassociation); pool
contents written by the two are bitwise equal.
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
    # paged writes through kernels/paged_maintenance (job-list chunk write
    # with deferred clear-on-alloc; copy-on-write kernel in the engine)
    fused_maintenance = False

    def attend_chunk(self, q: torch.Tensor, cache: Dict, pos0: torch.Tensor,
                     cfg: ModelConfig, *, rope_theta: float, window: int = 0,
                     rope_applied: bool = False, paged=None) -> torch.Tensor:
        """q (B, T, q_size) flat (pre-RoPE unless ``rope_applied``); lane t
        sits at ``pos0 + t``. ``paged`` (an ``attention.PageTables``) means
        ``cache`` is pool storage (num_pages, page_size, ...). -> (B, T,
        H*hd) context."""
        raise NotImplementedError

    def attend_mla(self, params: Dict, q_nope: torch.Tensor,
                   q_pe: torch.Tensor, cache: Dict, pos0: torch.Tensor,
                   cfg: ModelConfig, *, paged=None) -> torch.Tensor:
        """Absorbed-form MLA latent attend. q_nope (B, T, H, dn) before
        absorption, q_pe (B, T, H, dr) post-RoPE; lane t at ``pos0 + t``.
        -> (B, T, H, v_head_dim) context."""
        raise NotImplementedError


class ReferenceBackend(AttnBackend):
    name = 'reference'

    def attend_chunk(self, q, cache, pos0, cfg, *, rope_theta, window=0,
                     rope_applied=False, paged=None):
        from repro_torch.models import attention as A
        if paged is not None:
            table, Sc = paged.table_for(window, cache['k'].shape[1])
            cache = A.paged_view(cache, table, Sc)
        return A.decode_attend_chunk(q, cache, pos0, cfg,
                                     rope_theta=rope_theta, window=window,
                                     rope_applied=rope_applied)

    def attend_mla(self, params, q_nope, q_pe, cache, pos0, cfg, *,
                   paged=None):
        from repro_torch.models import attention as A
        from repro_torch.models import mla as M
        if paged is not None:                  # MLA layers: append-only
            table, Sc = paged.table_for(0, cache['ckv'].shape[1])
            cache = A.paged_view(cache, table, Sc)
        T = q_nope.shape[1]
        pos_t = pos0[:, None].long() + torch.arange(T, device=q_nope.device)
        return torch.stack(
            [M._mla_attend_lane(params, q_nope[:, t], q_pe[:, t], cache,
                                pos_t[:, t], cfg) for t in range(T)], dim=1)


class CudaBackend(AttnBackend):
    name = 'cuda'
    fused_maintenance = True

    def __init__(self, mesh=None):
        # mesh (a launch.mesh.ServingMesh): every chunk attend, on pool
        # pages and on the int8 pool, runs one kernel launch per kv-head
        # shard (port of the JAX package's ShardedPallasBackend). MLA keeps
        # the one-device attend, as in JAX. Unlike JAX, fused maintenance
        # stays on: the engine gathers the pool onto its primary device for
        # every step, so the maintenance kernels run there on the whole
        # pool, unchanged.
        self.mesh = mesh

    def attend_chunk(self, q, cache, pos0, cfg, *, rope_theta, window=0,
                     rope_applied=False, paged=None):
        from repro_torch.kernels.paged_attention import (
            dense_as_pages, dense_identity_table, dense_page_split,
            sharded_paged_attention)
        B, T = q.shape[0], q.shape[1]
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = q.reshape(B, T, H, hd)
        if cfg.pos == 'rope' and not rope_applied:
            pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
            q = L.apply_rope(q, pos_t, rope_theta)
        k = cache['k']
        quant = 'k_scale' in cache
        names = ('k', 'v', 'pos', 'k_scale', 'v_scale') if quant \
            else ('k', 'v', 'pos')
        if paged is not None:                 # pool pages, in place
            table, _ = paged.table_for(window, k.shape[1])
            pages = {nm: cache[nm] for nm in names}
        else:                                 # dense caches as pages
            Sc = k.shape[1]
            ps = dense_page_split(Sc)
            pages = {nm: dense_as_pages(cache[nm], ps) for nm in names}
            table = dense_identity_table(B, Sc, ps, q.device)
        pos0 = pos0.to(torch.int32).contiguous()
        qg = q.reshape(B, T, KV, H // KV, hd)
        # int8: q keeps its dtype; else one dtype for q, K and V (queries
        # follow the cache)
        ctx = sharded_paged_attention(
            (qg if quant else qg.to(k.dtype)).contiguous(), pages['k'],
            pages['v'], pages['pos'], table, pos0, mesh=self.mesh,
            scale=hd ** -0.5, window=window,
            k_scale_pages=pages.get('k_scale'),
            v_scale_pages=pages.get('v_scale'))
        return ctx.reshape(B, T, H * hd).to(q.dtype)

    def attend_mla(self, params, q_nope, q_pe, cache, pos0, cfg, *,
                   paged=None):
        from repro_torch.kernels.paged_attention import (dense_as_pages,
                                                         dense_identity_table,
                                                         dense_page_split,
                                                         paged_attention)
        m = cfg.mla
        ckv = cache['ckv']
        q_abs = torch.einsum('bthd,rhd->bthr', q_nope.float(),
                             params['wuk'].float())
        qcat = torch.cat([q_abs, q_pe.float()], dim=-1)[:, :, None]
        leaves = (ckv, cache['kpe'], cache['pos'])
        if paged is not None:                 # pool pages, in place
            table, _ = paged.table_for(0, ckv.shape[1])
        else:                                 # dense caches as pages
            B, Sc = ckv.shape[:2]
            ps = dense_page_split(Sc)
            leaves = tuple(dense_as_pages(x, ps) for x in leaves)
            table = dense_identity_table(B, Sc, ps, ckv.device)
        ckv_p, kpe_p, cpos = leaves
        ctx_lat = paged_attention(
            qcat.contiguous(), ckv_p[:, :, None], None, cpos, table,
            pos0.to(torch.int32).contiguous(),
            scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5,
            k2_pages=kpe_p[:, :, None], mla_split=m.kv_lora_rank)[:, :, 0]
        ctx_lat = ctx_lat.to(ckv.dtype)                      # (B, T, H, r)
        return torch.einsum('bthr,rhd->bthd', ctx_lat,
                            params['wuv'].to(ctx_lat.dtype))


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
