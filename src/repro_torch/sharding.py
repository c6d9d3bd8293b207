"""Where the serving engine keeps its state at rest on a ``('pool', 'heads')``
mesh (port of ``repro/sharding.py::serving_rules`` with the divisibility
fallback of ``Rules.spec_for_shape`` and the per-leaf axes of the JAX
engine's ``_leaf_axes``).

A state leaf names a *logical* axis per dimension (:func:`leaf_axes`);
:data:`SERVING_RULES` maps the logical axes to mesh axes: the page pool's
``pages`` axis and per-slot state's ``batch`` axis go over ``'pool'``, K/V
storage's ``kv_heads`` axis over ``'heads'``, everything else is
replicated. A dimension that its mesh axis does not divide is replicated
(:func:`spec_for_shape`).

At rest a leaf is a :class:`ShardedLeaf`: a P x H grid of contiguous
blocks, block ``(i, h)`` on ``mesh.devices[i][h]`` holding pages
``partition_pages(NP, P)[i]`` and kv heads ``h*KV/H : (h+1)*KV/H``; along a
replicated dimension every block holds the whole extent. :func:`shard_leaf`
cuts a full leaf into its blocks, :func:`gather_leaf` joins them again on
one device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import ServingMesh

# logical axis -> mesh axis; a logical axis not listed is replicated
SERVING_RULES = {'pages': 'pool', 'batch': 'pool', 'kv_heads': 'heads'}


def leaf_axes(name: str, ndim: int, stacked: bool,
              pooled: bool) -> List[Optional[str]]:
    """Logical axes of one state leaf: the lead axis (after the ``body``
    part's axis over stacked layers) is ``'pages'`` for pool leaves and
    ``'batch'`` for per-slot leaves; K/V storage's kv-head axis is ``-2``
    for ``k`` / ``v`` (..., tokens, KV, hd) and ``-1`` for their int8
    scales (..., tokens, KV)."""
    lead = 1 if stacked else 0
    axes: List[Optional[str]] = [None] * ndim
    if ndim > lead:
        axes[lead] = 'pages' if pooled else 'batch'
    if name in ('k', 'v') and ndim - lead >= 3:
        axes[-2] = 'kv_heads'
    elif name in ('k_scale', 'v_scale') and ndim - lead >= 2:
        axes[-1] = 'kv_heads'
    return axes


def spec_for_shape(mesh: Optional[ServingMesh], shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]]
                   ) -> Tuple[Optional[str], ...]:
    """The mesh axis each dimension is split over, or None (replicated).
    A mesh axis splits at most one dimension (the first that names it),
    and only a dimension it divides."""
    used: set = set()
    out: List[Optional[str]] = []
    for dim, ax in zip(shape, logical_axes):
        m = SERVING_RULES.get(ax) if ax is not None else None
        if m is None or m in used or mesh is None:
            out.append(None)
            continue
        used.add(m)
        out.append(m if dim % mesh.sizes[m] == 0 else None)
    return tuple(out)


@dataclasses.dataclass
class ShardedLeaf:
    """One state leaf at rest: ``blocks[i][h]`` lives on
    ``mesh.devices[i][h]``; ``spec`` names each dimension's mesh axis
    (:func:`spec_for_shape`)."""
    blocks: Tuple[Tuple[torch.Tensor, ...], ...]
    spec: Tuple[Optional[str], ...]
    shape: torch.Size

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype


def _block_view(x: torch.Tensor, spec, sizes: dict, i: int,
                h: int) -> torch.Tensor:
    """Block (i, h)'s view of the full ``x``."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            n = x.shape[dim] // sizes[ax]
            x = x.narrow(dim, (i if ax == 'pool' else h) * n, n)
    return x


def shard_leaf(x: torch.Tensor, spec: Tuple[Optional[str], ...],
               mesh: ServingMesh) -> ShardedLeaf:
    """Cut ``x`` into its blocks: each a contiguous tensor of its own
    on its mesh device."""
    P, H = mesh.shape
    blocks = []
    for i in range(P):
        row = []
        for h in range(H):
            view = _block_view(x, spec, mesh.sizes, i, h)
            row.append(torch.empty(view.shape, dtype=x.dtype,
                                   device=mesh.devices[i][h]).copy_(view))
        blocks.append(tuple(row))
    return ShardedLeaf(tuple(blocks), tuple(spec), x.shape)


def gather_leaf(leaf: ShardedLeaf, device: torch.device) -> torch.Tensor:
    """The full leaf on ``device``, from one block per distinct part (a
    replicated dimension is read from block 0 along its mesh axis)."""
    P, H = len(leaf.blocks), len(leaf.blocks[0])
    sizes = {'pool': P, 'heads': H}
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    rows = range(P) if 'pool' in leaf.spec else (0,)
    cols = range(H) if 'heads' in leaf.spec else (0,)
    for i in rows:
        for h in cols:
            _block_view(out, leaf.spec, sizes, i, h).copy_(leaf.blocks[i][h])
    return out
