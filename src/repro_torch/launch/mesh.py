"""The serving engine's ``('pool', 'heads')`` device mesh (port of
``repro/launch/mesh.py::make_serving_mesh``).

JAX's ``Mesh`` is a grid of devices that one controller drives. Its
counterpart here is the same: a :class:`ServingMesh` is a ``P x H`` grid of
``torch.device`` s that one process drives (no ``torch.distributed`` group,
whose ranks are processes). ``devices[0][0]`` is the *primary* device: the
engine's weights, its compute and the gathered state live there, and the
grid holds state at rest (``repro_torch.sharding``) and runs the
head-parallel attend (``kernels.paged_attention.sharded_paged_attention``).

A device may appear more than once in the grid: ``[cpu] * 4`` emulates a
``2x2`` mesh on the CPU, as the JAX tests emulate 4 CPU devices, and
``[cuda:0] * 4`` runs the mesh on one GPU. Repeating a device is always the
caller's choice (``devices=``); :func:`make_serving_mesh` without it takes
distinct GPUs or raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

AXES = ('pool', 'heads')


def resolve_device(device: 'torch.device | str') -> torch.device:
    """``device`` with its index made explicit (``'cuda'`` -> the current
    CUDA device), so two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """``shape`` (P, H) and a P x H grid of devices; ``devices[i][h]``
    holds pool block ``i`` and kv-head block ``h`` of the state at rest."""
    shape: Tuple[int, int]
    devices: Tuple[Tuple[torch.device, ...], ...]

    def __post_init__(self):
        p, h = self.shape
        if len(self.devices) != p or any(len(row) != h
                                         for row in self.devices):
            raise ValueError(f'serving mesh {p}x{h} needs a {p}x{h} grid of '
                             f'devices, got {[len(r) for r in self.devices]}')
        kinds = {torch.device(d).type for row in self.devices for d in row}
        if len(kinds) != 1:
            # a shard on another kind of device would run there quietly
            # (the plain version on the CPU for tensors of the card)
            raise ValueError(f'serving mesh devices must all be of one type, '
                             f'got {sorted(kinds)}')

    @property
    def sizes(self) -> dict:
        return dict(zip(AXES, self.shape))

    @property
    def primary(self) -> torch.device:
        return self.devices[0][0]


def parse_mesh_spec(spec) -> Optional[Tuple[int, int]]:
    """``None`` / ``''`` -> None; ``'PxH'`` / ``'P×H'`` / ``(P, H)`` ->
    ``(P, H)``. Raises :class:`ValueError` with the JAX package's messages on
    malformed specs and non-positive factors."""
    if spec is None or spec == '':
        return None
    if isinstance(spec, str):
        parts = spec.lower().replace('×', 'x').split('x')
        if len(parts) != 2:
            raise ValueError(f'mesh spec must look like "PxH" (e.g. "2x2"), '
                             f'got {spec!r}')
        try:
            shape = (int(parts[0]), int(parts[1]))
        except ValueError:
            raise ValueError(f'mesh spec must be two integers "PxH", got '
                             f'{spec!r}') from None
    else:
        shape = tuple(int(v) for v in spec)
        if len(shape) != 2:
            raise ValueError(f'mesh shape must be (pool, heads), got {spec!r}')
    p, h = shape
    if p < 1 or h < 1:
        raise ValueError(f'mesh factors must be positive, got {p}x{h}')
    return p, h


def make_serving_mesh(spec, devices: Optional[Sequence] = None
                      ) -> Optional[ServingMesh]:
    """Build (or pass through) the serving engine's ``('pool','heads')`` mesh.

    ``spec`` accepts:
      - ``None`` / ``''`` / ``'1x1'`` -> ``None`` (the one-device engine;
        no mesh code runs)
      - ``'PxH'`` (e.g. ``'2x2'``, ``'4x1'``) or a ``(P, H)`` tuple -> a
        :class:`ServingMesh` over the first ``P * H`` of ``devices``
        (row-major: ``devices[i * H + h]`` is grid entry ``(i, h)``); without
        ``devices``, the first ``P * H`` CUDA devices
      - an existing :class:`ServingMesh` -> returned as it is

    Raises :class:`ValueError` (these are user-facing CLI inputs) on
    malformed specs, non-positive factors, or more devices than there are.
    """
    if isinstance(spec, ServingMesh):
        return spec
    shape = parse_mesh_spec(spec)
    if shape is None:
        return None
    p, h = shape
    if p * h == 1:
        return None
    avail = list(devices) if devices is not None else \
        [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    if p * h > len(avail):
        raise ValueError(
            f'mesh {p}x{h} needs {p * h} devices but only {len(avail)} are '
            f'visible (to run the mesh on fewer devices, repeat one: pass '
            f'devices=[torch.device("cpu")] * {p * h}, or a CUDA device '
            f'{p * h} times)')
    grid = [resolve_device(d) for d in avail[:p * h]]
    return ServingMesh((p, h), tuple(tuple(grid[i * h:(i + 1) * h])
                                     for i in range(p)))
