"""Fused precomputed-row gather + layer-0 RoPE: rows ``table[ids]`` with each
static segment ``(offset, heads, head_dim)`` half-split rotated for its
token's position (fp32 trigonometry, result cast to the table dtype).

Port of ``repro/kernels/gather_rope.py::gather_rope`` (Pallas). The CUDA
kernel is ``repro_torch/csrc/gather_rope.cu``; it rotates by the inverse
frequencies of :func:`repro_torch.models.layers.rope_freqs`, the same fp32
vector the plain version uses, built on the device once per (head widths,
theta, device) and kept: after the first call a call allocates its output
and launches one kernel. The kernel takes at most ``MAX_SEGS`` segments and
``MAX_HEADS`` rotated heads over all of them; the wrapper raises beyond.
No 128-lane padding of the row width.
Ids follow ``jnp.take``, as the unfused table read does; the JAX Pallas
kernel clamps out-of-range ids instead (ROADMAP C2).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import dtype_code, on_cpu, require
from repro_torch.models.layers import rope_freqs, take_rows

Segs = Tuple[Tuple[int, int, int], ...]
# segments per launch (csrc kMaxSegs): GQA rows have 2 (q, k); MLA rows one
# per head's q_pe slice plus k_pe, 17 for deepseek-v2-lite-16b
MAX_SEGS = 32
# rotated heads over all segments per launch (csrc kMaxHeads): llama3-405b's
# 128 q + 8 k heads, up to 128 q + 64 k; the kernel's plan of head columns
# and tiles then stays a 4 KB kernel parameter. The plain version has no
# such limit
MAX_HEADS = 192
_INV: Dict[tuple, torch.Tensor] = {}
_SEG_ARGS: Dict[Segs, tuple] = {}


def inverse_frequencies(hds: Tuple[int, ...], theta: float,
                        device: torch.device) -> torch.Tensor:
    """The kernel's fp32 frequency vector: :func:`rope_freqs` of each head
    width in ``hds``, one after the other, made on ``device`` at the first
    call for these arguments and kept. A first call may not fall inside a
    CUDA graph capture (the vector would live in the graph's memory)."""
    key = (hds, float(theta), torch.device(device))
    inv = _INV.get(key)
    if inv is None:
        require(not (key[2].type == 'cuda'
                     and torch.cuda.is_current_stream_capturing()),
                'gather_rope', 'the first call for these head widths and '
                'theta must not be captured in a CUDA graph')
        inv = torch.cat([rope_freqs(hd, theta, device) for hd in hds])
        _INV[key] = inv
    return inv


def _seg_args(segs: Segs) -> tuple:
    """ctypes arrays of the segments' offsets, heads, widths and frequency
    offsets, and their head widths in order, for the kernel; kept per
    segment tuple."""
    args = _SEG_ARGS.get(segs)
    if args is None:
        hds = tuple(sorted({hd for _, _, hd in segs}))
        starts = dict(zip(hds, [sum(h // 2 for h in hds[:i])
                                for i in range(len(hds))]))

        def arr(vals):
            return (ctypes.c_int * MAX_SEGS)(*vals)
        args = (hds, arr([s[0] for s in segs]), arr([s[1] for s in segs]),
                arr([s[2] for s in segs]), arr([starts[s[2]] for s in segs]))
        _SEG_ARGS[segs] = args
    return args


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
    require(sum(s[1] for s in segs) <= MAX_HEADS, name,
            f'at most {MAX_HEADS} rotated heads over all segments')
    code = dtype_code(name, table)
    N = ids.shape[0]
    out = torch.empty((N, W), dtype=table.dtype, device=table.device)
    if N == 0:
        return out
    hds, offs, heads, widths, ioff = _seg_args(segs)
    inv = inverse_frequencies(hds, theta, table.device)
    build.check(build.load(name).gather_rope(
        table.data_ptr(), ids.data_ptr(), positions.data_ptr(),
        inv.data_ptr(), out.data_ptr(), N, V, W, code,
        ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(heads, ctypes.c_void_p),
        ctypes.cast(widths, ctypes.c_void_p), ctypes.cast(ioff, ctypes.c_void_p),
        len(segs), build.stream_of(table)), name)
    gather_rope.launches += 1
    return out


gather_rope.launches = 0
