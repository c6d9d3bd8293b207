"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

A copy of ``repro.configs`` restricted to the architectures the port serves
so far. Every module defines ``config()`` (exact published dims) and
``smoke_config()`` (reduced, for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.config import ModelConfig

# the paper's serial example; other families join as their modules are ported
ALL_IDS: List[str] = ['mistral_7b']


def _norm(name: str) -> str:
    return name.replace('-', '_').replace('.', '_')


def _module(name: str):
    key = _norm(name)
    if key not in ALL_IDS:
        raise NotImplementedError(
            f'{name!r} is not ported to repro_torch yet; ported: {ALL_IDS}')
    return importlib.import_module(f'repro_torch.configs.{key}')


def get_config(name: str) -> ModelConfig:
    cfg = _module(name).config()
    cfg.validate()
    return cfg


def get_smoke_config(name: str) -> ModelConfig:
    cfg = _module(name).smoke_config()
    cfg.validate()
    return cfg
