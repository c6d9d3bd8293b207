"""Fused RMSNorm + Q/K/V projection: ``(x * rsqrt(mean(x^2) + eps) * scale)
@ [Wq|Wk|Wv]``, normalising and accumulating in fp32 — layer 0's work that
the precomputed table removes, and every later layer's LN1+QKV in the
full-sequence forward.

Port of ``repro/kernels/rmsnorm_qkv.py::rmsnorm_matmul`` (Pallas) and of its
``ops.rmsnorm_qkv`` wrapper. The CUDA kernel is
``repro_torch/csrc/rmsnorm_matmul.cu``; it takes the three weight matrices
as separate pointers, so nothing concatenates ``[Wq|Wk|Wv]`` per call, and
writes q, k and v as three contiguous outputs. Unlike the JAX wrapper there
is no padding of N or W to 128: that is a TPU tiling constraint.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import dtype_code, on_cpu, require

EPS = 1e-6


def _normed(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * scale.float()


def rmsnorm_matmul_plain(x: torch.Tensor, scale: torch.Tensor,
                         w: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """The kernel's plain version (mirrors ``_rmsnorm_matmul_kernel``):
    x (N, d) -> (N, W) in x's dtype."""
    return (_normed(x, scale, eps) @ w.float()).to(x.dtype)


def rmsnorm_qkv_plain(x: torch.Tensor, scale: torch.Tensor, wq: torch.Tensor,
                      wk: torch.Tensor, wv: torch.Tensor, eps: float = EPS
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mirrors ``ref.rmsnorm_qkv_ref``: the norm in fp32, ``xn`` kept in
    fp32 and multiplied by the fp32 weights, each output cast to x's
    dtype."""
    xn = _normed(x, scale, eps)
    return tuple((xn @ w.float()).to(x.dtype) for w in (wq, wk, wv))


def _launch(x: torch.Tensor, scale: torch.Tensor, ws: List[torch.Tensor],
            eps: float) -> List[torch.Tensor]:
    """One launch of the CUDA kernel over 1-3 weight matrices; x (N, d)."""
    name = 'rmsnorm_matmul'
    require(x.dim() == 2, name, f'x must be (N, d), got {tuple(x.shape)}')
    N, d = x.shape
    code = dtype_code(name, x)
    require(scale.shape == (d,), name, f'scale must be ({d},)')
    for t in (scale, *ws):
        require(t.dtype == x.dtype, name,
                f'all tensors must share x\'s dtype {x.dtype}, got {t.dtype}')
    for w in ws:
        require(w.dim() == 2 and w.shape[0] == d, name,
                f'weights must be ({d}, W), got {tuple(w.shape)}')
    for nm, t in (('x', x), ('scale', scale), *(('w', w) for w in ws)):
        require(t.is_contiguous(), name, f'{nm} must be contiguous')
    outs = [torch.empty((N, w.shape[1]), dtype=x.dtype, device=x.device)
            for w in ws]
    if N == 0:
        return outs
    pad = 3 - len(ws)
    wp = [w.data_ptr() for w in ws] + [0] * pad
    op = [o.data_ptr() for o in outs] + [0] * pad
    widths = [w.shape[1] for w in ws] + [0] * pad
    lib = build.load(name)
    build.check(lib.rmsnorm_matmul(x.data_ptr(), scale.data_ptr(), *wp, *op,
                                   *widths, len(ws), N, d, float(eps), code,
                                   build.stream_of(x)), name)
    rmsnorm_matmul.launches += 1
    return outs


def rmsnorm_matmul(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   eps: float = EPS) -> torch.Tensor:
    """x (N, d), scale (d,), w (d, W) -> (N, W) in x's dtype (float32 or
    bfloat16; all three tensors of that dtype). CPU tensors take
    :func:`rmsnorm_matmul_plain`; CUDA tensors launch the kernel. Counts
    launches in ``rmsnorm_matmul.launches``."""
    if on_cpu('rmsnorm_matmul', x, scale, w):
        return rmsnorm_matmul_plain(x, scale, w, eps)
    return _launch(x, scale, [w], eps)[0]


rmsnorm_matmul.launches = 0


def rmsnorm_qkv(x: torch.Tensor, scale: torch.Tensor, wq: torch.Tensor,
                wk: torch.Tensor, wv: torch.Tensor, eps: float = EPS
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., d) -> q (..., Q), k (..., E), v (..., E), as JAX's
    ``ops.rmsnorm_qkv``. CPU tensors take :func:`rmsnorm_qkv_plain`; CUDA
    tensors make one launch of the ``rmsnorm_matmul`` kernel over the three
    matrices (counted in ``rmsnorm_matmul.launches``)."""
    lead, d = tuple(x.shape[:-1]), x.shape[-1]
    x2 = x.reshape(-1, d)
    if on_cpu('rmsnorm_matmul', x, scale, wq, wk, wv):
        outs = rmsnorm_qkv_plain(x2, scale, wq, wk, wv, eps)
    else:
        outs = _launch(x2.contiguous(), scale, [wq, wk, wv], eps)
    return tuple(o.reshape(lead + (o.shape[-1],)) for o in outs)
