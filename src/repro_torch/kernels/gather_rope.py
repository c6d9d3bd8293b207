"""Fused precomputed-row gather + layer-0 RoPE: rows ``table[ids]`` with each
static segment ``(offset, heads, head_dim)`` half-split rotated for its
token's position (fp32 trigonometry, result cast to the table dtype).

Port of ``repro/kernels/gather_rope.py::gather_rope`` (Pallas). The CUDA
kernel is ``repro_torch/csrc/gather_rope.cu``; it rotates by the inverse
frequencies of :func:`repro_torch.models.layers.rope_freqs`, the same fp32
vector the plain version uses. No 128-lane padding of the row width.
Ids follow ``jnp.take``, as the unfused table read does; the JAX Pallas
kernel clamps out-of-range ids instead (ROADMAP C2).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import dtype_code, on_cpu, require
from repro_torch.models.layers import rope_freqs, take_rows

Segs = Tuple[Tuple[int, int, int], ...]
# segments per launch (csrc kMaxSegs): GQA rows have 2 (q, k); MLA rows one
# per head's q_pe slice plus k_pe, 17 for deepseek-v2-lite-16b
MAX_SEGS = 32


def _check_segs(segs: Sequence[Tuple[int, int, int]], W: int) -> Segs:
    segs = tuple(sorted(tuple(int(v) for v in s) for s in segs))
    end = 0
    for off, heads, hd in segs:
        require(hd % 2 == 0 and heads > 0 and off >= end
                and off + heads * hd <= W, 'gather_rope',
                f'bad segments {segs} for row width {W}')
        end = off + heads * hd
    return segs


def gather_rope_plain(table: torch.Tensor, ids: torch.Tensor,
                      positions: torch.Tensor, *, segs,
                      theta: float) -> torch.Tensor:
    """table (V, W), ids (N,), positions (N,) -> (N, W); the plain version
    (mirrors the JAX oracle ``ref.gather_rope_ref``). Rows are read by
    :func:`~repro_torch.models.layers.take_rows` (``jnp.take``): an id in
    ``[-V, 0)`` wraps, an id outside ``[-V, V)`` gives a row of NaN."""
    rows = take_rows(table, ids)
    N = rows.shape[0]
    out = rows.clone()
    for off, heads, hd in _check_segs(segs, table.shape[1]):
        half = hd // 2
        seg = rows[:, off:off + heads * hd].reshape(N, heads, hd).float()
        inv = rope_freqs(hd, theta, table.device)
        ang = positions.float()[:, None] * inv                   # (N, half)
        sin = torch.sin(ang)[:, None, :]
        cos = torch.cos(ang)[:, None, :]
        x1, x2 = seg[..., :half], seg[..., half:]
        rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                        dim=-1).reshape(N, heads * hd)
        out[:, off:off + heads * hd] = rot.to(table.dtype)
    return out


def gather_rope(table: torch.Tensor, ids: torch.Tensor,
                positions: torch.Tensor, *, segs, theta: float
                ) -> torch.Tensor:
    """table (V, W), ids (N,) int32, positions (N,) int32 -> rows (N, W).

    CPU tensors take :func:`gather_rope_plain`; CUDA tensors launch the
    kernel. Counts launches in ``gather_rope.launches``.
    """
    name = 'gather_rope'
    if on_cpu(name, table, ids, positions):
        return gather_rope_plain(table, ids, positions, segs=segs,
                                 theta=theta)
    require(table.dim() == 2 and table.is_contiguous(), name,
            'table must be a contiguous (V, W) matrix')
    for nm, t in (('ids', ids), ('positions', positions)):
        require(t.dim() == 1 and t.dtype == torch.int32 and t.is_contiguous()
                and t.shape[0] == ids.shape[0], name,
                f'{nm} must be contiguous (N,) int32')
    V, W = table.shape
    segs = _check_segs(segs, W)
    require(len(segs) <= MAX_SEGS, name, f'at most {MAX_SEGS} segments')
    code = dtype_code(name, table)
    N = ids.shape[0]
    out = torch.empty((N, W), dtype=table.dtype, device=table.device)
    if N == 0:
        return out
    # one inverse-frequency vector per distinct head width (MLA's 17
    # segments share one), made on the device in this call
    hds = sorted({hd for _, _, hd in segs})
    inv = torch.cat([rope_freqs(hd, theta, table.device) for hd in hds])
    starts = dict(zip(hds, [sum(h // 2 for h in hds[:i])
                            for i in range(len(hds))]))
    inv_off = [starts[hd] for _, _, hd in segs]

    def arr(vals):
        return (ctypes.c_int * MAX_SEGS)(*vals)

    offs, heads, hds = (arr([s[i] for s in segs]) for i in range(3))
    ioff = arr(inv_off)
    lib = build.load(name)
    build.check(lib.gather_rope(
        table.data_ptr(), ids.data_ptr(), positions.data_ptr(),
        inv.data_ptr(), out.data_ptr(), N, V, W, code,
        ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(heads, ctypes.c_void_p),
        ctypes.cast(hds, ctypes.c_void_p), ctypes.cast(ioff, ctypes.c_void_p),
        len(segs), build.stream_of(table)), name)
    gather_rope.launches += 1
    return out


gather_rope.launches = 0
