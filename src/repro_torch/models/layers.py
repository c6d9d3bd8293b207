"""Primitive layers, ported from ``repro/models/layers.py``.

Parameters are the JAX package's nested dicts (``{'w': (d_in, d_out)}`` for
a dense layer, with ``'b': (d_out,)`` where it has a bias, ``{'scale':
(d,)}`` for an RMSNorm, ``{'scale', 'bias'}`` for a LayerNorm), held as
torch tensors; see ``repro_torch.params``. Norms and RoPE compute in fp32
and cast back to the input dtype, as in JAX.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape and initialiser of one parameter leaf (as ``repro``'s
    ``ParamSpec``, without the sharding axes)."""
    shape: Tuple[int, ...]
    init: str = 'fan_in'            # 'fan_in' | 'normal' | 'zeros' | 'ones'
    init_scale: float = 1.0
    dtype: Optional[str] = None     # None -> the model's dtype


def dense_schema(d_in: int, d_out: int, *,
                 bias: bool = False) -> Dict[str, ParamSpec]:
    sch = {'w': ParamSpec((d_in, d_out))}
    if bias:
        sch['b'] = ParamSpec((d_out,), 'zeros')
    return sch


def stack_schema(schema, n: int):
    """The schema with a leading stacking dimension of size n on every leaf
    (the layers of a pattern slot, looped over in place of JAX's scan)."""
    if isinstance(schema, ParamSpec):
        return ParamSpec((n,) + schema.shape, schema.init, schema.init_scale,
                         schema.dtype)
    if isinstance(schema, dict):
        return {k: stack_schema(v, n) for k, v in schema.items()}
    return type(schema)(stack_schema(v, n) for v in schema)


def norm_schema(d: int, kind: str) -> Dict[str, ParamSpec]:
    if kind == 'rmsnorm':
        return {'scale': ParamSpec((d,), 'ones')}
    return {'scale': ParamSpec((d,), 'ones'),
            'bias': ParamSpec((d,), 'zeros')}


# ===================================================================== norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (mean and variance over the last axis), cast back
    to the input dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_apply(params: Dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == 'rmsnorm':
        return rmsnorm(x, params['scale'])
    return layernorm(x, params['scale'], params['bias'])


# ==================================================================== linear
def dense(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w``, plus the bias ``b`` where the leaf has one (the encoder's
    ``proj_in``, the VLM projector); bias-free leaves are unchanged."""
    y = x @ params['w']
    if 'b' in params:
        y = y + params['b'].to(y.dtype)
    return y


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


def sincos_pos_embedding(seq_len: int, d: int,
                         device: torch.device | str = 'cpu') -> torch.Tensor:
    """Classic sinusoidal table (the whisper encoder's): (seq_len, d) fp32,
    sin at even columns, cos at odd ones, made in float64 with numpy as
    JAX makes it. Made and copied to ``device`` once for each (seq_len,
    d, device) and shared after that (JAX folds it as a constant), so a
    caller must not write into it."""
    return _sincos_table(seq_len, d, torch.device(device))


@functools.lru_cache(maxsize=8)
def _sincos_table(seq_len: int, d: int, device: torch.device) -> torch.Tensor:
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((seq_len, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


# ================================================================= embedding
def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ``jnp.take``'s default semantics: ids in
    ``[-V, 0)`` read row ``id + V``, ids outside ``[-V, V)`` give a row of
    NaN in the table's dtype. Indexes only in range, so no id can fault on
    the card."""
    V = table.shape[0]
    i = ids.long()
    ok = (i >= -V) & (i < V)
    rows = table[torch.where(i < 0, i + V, i).clamp(0, V - 1)]
    nan = torch.full((), float('nan'), dtype=table.dtype, device=table.device)
    return torch.where(ok[..., None], rows, nan)


def embed_lookup(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return take_rows(params['table'], tokens)


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
