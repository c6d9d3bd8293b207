"""Row gather from the precomputed first-layer table: ``rows[N, W] =
table[ids]`` — the paper's one row read per token.

Port of ``repro/kernels/embed_gather.py::embed_gather`` (Pallas). The CUDA
kernel is ``repro_torch/csrc/embed_gather.cu``. Unlike the JAX wrapper
(``ops.embed_gather_rows``) there is no 128-lane padding of the row width:
that is a TPU tiling constraint.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_cpu, require


def embed_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, W), ids (N,) integer -> (N, W); the kernel's plain version."""
    return table[ids.long()]


def embed_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, W), ids (N,) int32 -> rows (N, W), bitwise ``table[ids]``.

    CPU tensors take :func:`embed_gather_plain`; CUDA tensors launch the
    kernel (ids outside ``[0, V)`` give zero rows there). Counts launches
    in ``embed_gather.launches``.
    """
    name = 'embed_gather'
    if on_cpu(name, table, ids):
        return embed_gather_plain(table, ids)
    require(table.dim() == 2 and table.is_contiguous(), name,
            f'table must be a contiguous (V, W) matrix, got {tuple(table.shape)}')
    require(ids.dim() == 1 and ids.dtype == torch.int32
            and ids.is_contiguous(), name, 'ids must be contiguous (N,) int32')
    V, W = table.shape
    N = ids.shape[0]
    out = torch.empty((N, W), dtype=table.dtype, device=table.device)
    if N == 0:
        return out
    lib = build.load(name)
    build.check(lib.embed_gather(table.data_ptr(), ids.data_ptr(),
                                 out.data_ptr(), N, V,
                                 W * table.element_size(),
                                 build.stream_of(table)), name)
    embed_gather.launches += 1
    return out


embed_gather.launches = 0
