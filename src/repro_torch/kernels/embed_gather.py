"""Row gather from the precomputed first-layer table: ``rows[N, W] =
table[ids]`` — the paper's one row read per token.

Port of ``repro/kernels/embed_gather.py::embed_gather`` (Pallas). The CUDA
kernel is ``repro_torch/csrc/embed_gather.cu``. Unlike the JAX wrapper
(``ops.embed_gather_rows``) there is no 128-lane padding of the row width:
that is a TPU tiling constraint. Ids follow ``jnp.take``, as the JAX
package's table read (``core/precompute.py``) does: ids in ``[-V, 0)``
wrap, ids outside ``[-V, V)`` give NaN rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_cpu, require
from repro_torch.models.layers import take_rows


def nan_word(dtype: torch.dtype) -> int:
    """The 32-bit pattern of NaNs of ``dtype`` (2 or 4 bytes) that the
    kernel writes into a row of an out-of-range id: ``torch``'s NaN, as
    the plain version writes it."""
    n = 4 // torch.empty((), dtype=dtype).element_size()
    return torch.full((n,), float('nan'), dtype=dtype).view(torch.int32).item()


def embed_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, W), ids (N,) integer -> (N, W); the kernel's plain version
    (:func:`~repro_torch.models.layers.take_rows`)."""
    return take_rows(table, ids)


def embed_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, W) float32 or bfloat16, ids (N,) int32 -> rows (N, W),
    bitwise :func:`embed_gather_plain` (a row of NaN for an id outside
    ``[-V, V)``, row ``id + V`` for an id in ``[-V, 0)``).

    CPU tensors take :func:`embed_gather_plain`; CUDA tensors launch the
    kernel. Counts launches in ``embed_gather.launches``.
    """
    name = 'embed_gather'
    if on_cpu(name, table, ids):
        return embed_gather_plain(table, ids)
    require(table.dim() == 2 and table.is_contiguous(), name,
            f'table must be a contiguous (V, W) matrix, got {tuple(table.shape)}')
    require(table.dtype in (torch.float32, torch.bfloat16), name,
            f'table must be float32 or bfloat16, got {table.dtype}')
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
                                 nan_word(table.dtype),
                                 build.stream_of(table)), name)
    embed_gather.launches += 1
    return out


embed_gather.launches = 0
