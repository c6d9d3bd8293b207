"""Checks shared by the kernel wrappers.

A wrapper runs its kernel's plain PyTorch version only because every tensor
it was given lies on the CPU; on CUDA tensors it launches the kernel or
raises — there is no fallback from the card to the plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True if every tensor is on the CPU; False if all are on one CUDA
    device; raises for any other mix."""
    devs = {t.device for t in tensors}
    if all(d.type == 'cpu' for d in devs):
        return True
    if len(devs) == 1 and next(iter(devs)).type == 'cuda':
        return False
    raise ValueError(f'{name}: tensors must all lie on the CPU or all on one '
                     f'CUDA device, got {sorted(map(str, devs))}')


def require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f'{name}: {msg}')


def dtype_code(name: str, t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    require(code is not None, name,
            f'dtype {t.dtype} not supported (float32 or bfloat16)')
    return code
