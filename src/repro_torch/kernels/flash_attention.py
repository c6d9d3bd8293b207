"""Blocked causal flash attention over a full sequence, with GQA and a sliding
window, masked by token positions — the core of the full-sequence forward
for long sequences (``models/attention.blocked_attention_core``).

Port of ``repro/kernels/flash_attention.py::flash_attention`` (Pallas); the
CUDA kernel is ``repro_torch/csrc/flash_attention.cu``.

Contract: q (B, S, H, d) post-RoPE queries, k and v (B, S, KV, d), positions
(B, S) int32 -> (B, S, H, d) in q's dtype; query head h reads kv head
``h // G`` (G = H / KV); scale ``d ** -0.5``. Key j is visible to query i
iff ``pos_j <= pos_i`` and ``j <= i`` (``causal``), and ``pos_i - pos_j <
window`` and ``i - j < window`` (when ``window > 0``); a query with no
visible key gives zeros. The CUDA kernel visits only the key tiles from
``max(0, q_start - window + 1)`` to the causal end, by index, and the rules
on indices make the plain version and the kernel agree on any positions.
Where positions rise by at least one per index — ``arange(S)`` plus an
offset, all the forward passes — the index rules follow from the position
rules, and the mask is the TPU kernel's index mask and the JAX blocked
core's position mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import dtype_code, on_cpu, require

HEAD_DIMS = (16, 32, 64, 128, 256)  # head widths the CUDA kernel is built for
MAX_GROUP = 64                     # query heads per kv head (one block's rows)
PLAIN_TILE = 512                   # queries per step of the plain version


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          positions: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The kernel's plain version (mirrors ``ref.flash_attention_ref``, with
    the mask of the module docstring): fp32 scores, a masked softmax over all
    keys, the output in q's dtype. Loops over tiles of ``PLAIN_TILE``
    queries, so memory stays O(S * PLAIN_TILE)."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, d).float()
    kf, vf = k.float(), v.float()
    pos = positions.long()
    out = torch.empty((B, S, KV, G, d), dtype=torch.float32, device=q.device)
    for a in range(0, S, PLAIN_TILE):
        e = min(S, a + PLAIN_TILE)
        s = torch.einsum('bqkgd,bskd->bkgqs', qg[:, a:e], kf) * d ** -0.5
        pi = pos[:, a:e, None]                              # (B, tq, 1)
        pj = pos[:, None, :]                                # (B, 1, S)
        ii = torch.arange(a, e, device=q.device)[:, None]   # (tq, 1)
        jj = torch.arange(S, device=q.device)[None]         # (1, S)
        vis = torch.ones_like(pi - pj, dtype=torch.bool)
        if causal:
            vis &= (pj <= pi) & (jj <= ii)
        if window:
            vis &= ((pi - pj) < window) & ((ii - jj) < window)
        vis = vis[:, None, None]                            # (B,1,1,tq,S)
        p = torch.softmax(s.masked_fill(~vis, float('-inf')), dim=-1)
        p = torch.where(vis, p, torch.zeros((), device=q.device))
        out[:, a:e] = torch.einsum('bkgqs,bskd->bqkgd', p, vf)
    return out.reshape(B, S, H, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """See the module docstring. CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel (q, k, v
    contiguous, of one dtype, float32 or bfloat16; d in ``HEAD_DIMS``; at
    most ``MAX_GROUP`` query heads per kv head). Counts launches in
    ``flash_attention.launches``."""
    name = 'flash_attention'
    if on_cpu(name, q, k, v, positions):
        return flash_attention_plain(q, k, v, positions, causal=causal,
                                     window=window)
    require(q.dim() == 4, name, f'q must be (B, S, H, d), got '
            f'{tuple(q.shape)}')
    B, S, H, d = q.shape
    KV = k.shape[2] if k.dim() == 4 else 0
    require(k.shape == (B, S, KV, d) and v.shape == k.shape, name,
            f'k and v must be (B, S, KV, d) = ({B}, {S}, KV, {d}), got '
            f'{tuple(k.shape)} / {tuple(v.shape)}')
    require(KV > 0 and H % KV == 0 and H // KV <= MAX_GROUP, name,
            f'H ({H}) must be a multiple of KV ({KV}) with at most '
            f'{MAX_GROUP} query heads per kv head')
    require(d in HEAD_DIMS, name, f'head width {d} not in {HEAD_DIMS}')
    require(positions.shape == (B, S) and positions.dtype == torch.int32,
            name, 'positions must be (B, S) int32')
    code = dtype_code(name, q)
    require(k.dtype == q.dtype and v.dtype == q.dtype, name,
            f'q, k and v must share a dtype, got {q.dtype}, {k.dtype}, '
            f'{v.dtype}')
    for nm, t in (('q', q), ('k', k), ('v', v)):
        require(t.is_contiguous() and t.data_ptr() % 16 == 0, name,
                f'{nm} must be contiguous and 16-byte aligned')
    require(positions.is_contiguous(), name, 'positions must be contiguous')
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    lib = build.load(name)
    build.check(lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
        out.data_ptr(), B, S, H, KV, d, int(bool(causal)), int(window),
        float(d ** -0.5), code, build.stream_of(q)), name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
