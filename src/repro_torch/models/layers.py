"""Primitive layers, ported from ``repro/models/layers.py``.

Parameters are the JAX package's nested dicts (``{'w': (d_in, d_out)}`` for
a dense layer, ``{'scale': (d,)}`` for a norm), held as torch tensors; see
``repro_torch.params``. Norms and RoPE compute in fp32 and cast back to the
input dtype, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape and initialiser of one parameter leaf (as ``repro``'s
    ``ParamSpec``, without the sharding axes)."""
    shape: Tuple[int, ...]
    init: str = 'fan_in'            # 'fan_in' | 'normal' | 'zeros' | 'ones'
    init_scale: float = 1.0


def dense_schema(d_in: int, d_out: int) -> Dict[str, ParamSpec]:
    return {'w': ParamSpec((d_in, d_out))}


def norm_schema(d: int, kind: str) -> Dict[str, ParamSpec]:
    if kind != 'rmsnorm':
        raise NotImplementedError(f'norm {kind!r} is not ported yet')
    return {'scale': ParamSpec((d,), 'ones')}


# ===================================================================== norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def norm_apply(params: Dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind != 'rmsnorm':
        raise NotImplementedError(f'norm {kind!r} is not ported yet')
    return rmsnorm(x, params['scale'])


# ==================================================================== linear
def dense(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params['w']


# ====================================================================== RoPE
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = 'cpu') -> torch.Tensor:
    """Inverse frequencies ``1 / theta^(2j / head_dim)`` in fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (float(theta) ** exponent)               # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs (half-split convention, llama style).

    x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions.float()[..., None] * inv              # (..., seq, hd/2)
    sin = torch.sin(ang)[..., None, :]                    # (..., seq, 1, hd/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ================================================================= embedding
def embed_lookup(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params['table'][tokens.long()]


# ================================================================ activations
def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    # jax.nn.gelu defaults to the tanh approximation, so both names map to it
    gelu_tanh = lambda x: F.gelu(x, approximate='tanh')  # noqa: E731
    return {'silu': F.silu, 'gelu': gelu_tanh, 'relu': F.relu,
            'gelu_tanh': gelu_tanh}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
