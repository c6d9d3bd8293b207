"""In-place paged/chunked attention of a whole query chunk, plus the helpers
that view a dense ring cache as identity-table pages.

Port of ``repro/kernels/paged_attention.py::paged_attention`` (Pallas),
without its int8 (``quant``) and MLA (``mla_split``) variants. The CUDA
kernel is ``repro_torch/csrc/paged_attention.cu``: one block per (slot,
kv head, tile of up to 64 of the T·G query rows) walks the slot's pages
through the table with an fp32 online softmax, so any chunk length and
group size fit one launch.

Contract (as the JAX kernel): q (B, T, KV, G, d) post-RoPE queries, lane t
at position ``pos0 + t``; k/v pages (NP, ps, KV, d); stored positions
(NP, ps) int32 (-1 = empty); table (B, P) int32; pos0 (B,) int32
-> (B, T, KV, G, d) in q's dtype. A key is valid for lane t iff its stored
position c has ``c >= 0``, ``c <= pos0 + t`` and, with a window,
``pos0 + t - c < window``; a lane with no valid key gives zeros.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import dtype_code, on_cpu, require

def page_validity(cpos: torch.Tensor, pos_t: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Stored positions (..., S) x query positions (..., T) -> (..., T, S)."""
    c = cpos[..., None, :]
    p = pos_t[..., :, None]
    v = (c >= 0) & (c <= p)
    if window:
        v &= (p - c) < window
    return v


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, cpos_pages: torch.Tensor,
                          table: torch.Tensor, pos0: torch.Tensor, *,
                          scale: float, window: int = 0) -> torch.Tensor:
    """The kernel's plain version: gather each slot's pages into a dense
    virtual cache, then masked fp32 softmax attention (mirrors the JAX
    oracle ``ref.paged_attention_ref``)."""
    B, T = q.shape[:2]
    P, ps = table.shape[1], k_pages.shape[1]
    tab = table.long()

    def virt(pages):                                   # (B, P*ps, ...)
        return pages[tab].reshape((B, P * ps) + tuple(pages.shape[2:]))

    cp = virt(cpos_pages)                                        # (B, S)
    pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
    s = torch.einsum('btkgd,bskd->bkgts', q.float(),
                     virt(k_pages).float()) * scale
    valid = page_validity(cp, pos_t, window)[:, None, None]      # (B,1,1,T,S)
    s = s.masked_fill(~valid, float('-inf'))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros((), device=q.device))  # empty -> 0
    o = torch.einsum('bkgts,bskd->btkgd', p, virt(v_pages).float())
    return o.to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, cpos_pages: torch.Tensor,
                    table: torch.Tensor, pos0: torch.Tensor, *, scale: float,
                    window: int = 0) -> torch.Tensor:
    """See the module docstring. CPU tensors take
    :func:`paged_attention_plain`; CUDA tensors launch the kernel (q, K and
    V share one dtype, float32 or bfloat16). Counts launches in
    ``paged_attention.launches``."""
    name = 'paged_attention'
    if on_cpu(name, q, k_pages, v_pages, cpos_pages, table, pos0):
        return paged_attention_plain(q, k_pages, v_pages, cpos_pages, table,
                                     pos0, scale=scale, window=window)
    require(q.dim() == 5, name, f'q must be (B, T, KV, G, d), got '
            f'{tuple(q.shape)}')
    B, T, KV, G, d = q.shape
    NP, ps = k_pages.shape[:2]
    require(k_pages.shape == (NP, ps, KV, d) and v_pages.shape == k_pages.shape,
            name, f'k/v pages must be (NP, ps, {KV}, {d}), got '
            f'{tuple(k_pages.shape)} / {tuple(v_pages.shape)}')
    require(cpos_pages.shape == (NP, ps) and cpos_pages.dtype == torch.int32,
            name, 'cpos pages must be (NP, ps) int32')
    require(table.dim() == 2 and table.shape[0] == B
            and table.dtype == torch.int32, name, 'table must be (B, P) int32')
    require(pos0.shape == (B,) and pos0.dtype == torch.int32, name,
            'pos0 must be (B,) int32')
    require(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype, name,
            f'q, K and V must share a dtype, got {q.dtype}, {k_pages.dtype}, '
            f'{v_pages.dtype}')
    for nm, t in (('q', q), ('k_pages', k_pages), ('v_pages', v_pages),
                  ('cpos_pages', cpos_pages), ('table', table),
                  ('pos0', pos0)):
        require(t.is_contiguous(), name, f'{nm} must be contiguous')
    code = dtype_code(name, q)
    lib = build.load(name)
    require(lib.paged_attention_smem(T * G, d) > 0, name,
            f'a tile of query rows of width {d} exceeds one block\'s shared '
            'memory')
    out = torch.empty_like(q)
    P = table.shape[1]
    build.check(lib.paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        cpos_pages.data_ptr(), table.data_ptr(), pos0.data_ptr(),
        out.data_ptr(), B, T, KV, G, d, NP, ps, P, float(scale),
        int(window), code, build.stream_of(q)), name)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


# ========================================== dense caches as identity pages
def dense_page_split(Sc: int, max_page: int = 128) -> int:
    """Page size for viewing a dense (B, Sc, ...) cache as pages in place:
    the largest power of two <= ``max_page`` that divides Sc (1 for odd
    ring lengths, which the kernel handles at the same cost)."""
    for bs in (max_page, 64, 32, 16, 8, 4, 2):
        if bs <= Sc and Sc % bs == 0:
            return bs
    return 1


def dense_as_pages(leaf: torch.Tensor, ps: int) -> torch.Tensor:
    """(B, Sc, ...) -> (B * Sc/ps, ps, ...) page view — no copy."""
    B, Sc = leaf.shape[:2]
    return leaf.view((B * (Sc // ps), ps) + tuple(leaf.shape[2:]))


def dense_identity_table(B: int, Sc: int, ps: int,
                         device: torch.device | str = 'cpu') -> torch.Tensor:
    """Page table mapping slot b's block j to physical page b * P + j."""
    P = Sc // ps
    return torch.arange(B * P, dtype=torch.int32, device=device).view(B, P)
