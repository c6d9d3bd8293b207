"""Feed-forward networks (port of ``repro/models/ffn.py``): 2-layer MLP and
GLU variants (SwiGLU etc.)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import layers as L


def ffn_schema(d: int, d_ff: int, *, glu: bool = True) -> Dict:
    sch = {'w_up': L.dense_schema(d, d_ff), 'w_down': L.dense_schema(d_ff, d)}
    if glu:
        sch['w_gate'] = L.dense_schema(d, d_ff)
    return sch


def ffn_apply(params: Dict, x: torch.Tensor, *, act: str = 'silu'
              ) -> torch.Tensor:
    a = L.activation(act)
    up = L.dense(params['w_up'], x)
    if 'w_gate' in params:
        h = a(L.dense(params['w_gate'], x)) * up
    else:
        h = a(up)
    return L.dense(params['w_down'], h)
