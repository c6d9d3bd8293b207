"""Fused RMSNorm + Q/K/V projection: ``(x * rsqrt(mean(x^2) + eps) * scale)
@ [Wq|Wk|Wv]``, normalising and accumulating in fp32 — layer 0's work that
the precomputed table removes, and every later layer's LN1+QKV in the
full-sequence forward.

Port of ``repro/kernels/rmsnorm_qkv.py::rmsnorm_matmul`` (Pallas) and of its
``ops.rmsnorm_qkv`` wrapper. The CUDA kernels are in
``repro_torch/csrc/rmsnorm_matmul.cu``; they take the three weight matrices
as separate pointers, so nothing concatenates ``[Wq|Wk|Wv]`` per call, and
write q, k and v as three contiguous outputs. Unlike the JAX wrapper there
is no padding of N or W to 128: that is a TPU tiling constraint.

A call on the card takes one of three forms (:data:`FORMS`), chosen by
shape in the C entry point (``rmsnorm_matmul_plan``):

- ``wgmma``: bf16 with N > 8 rows, d and every width multiples of 8,
  weights 16-byte aligned. The normalised rows are split into two bf16
  matrices, hi and lo, and a Hopper GEMM (TMA, ``wgmma``) sums hi @ W +
  lo @ W in fp32; :func:`rmsnorm_qkv_hilo_plain` is its arithmetic.
- ``splitk``: the same widths with N <= 8. ``x * scale`` in fp32 times the
  weights on the FMA units, d cut into slices whose fp32 partials (and
  sums of x^2) are summed in slice order, then scaled by the row's inverse
  RMS; :func:`rmsnorm_qkv_splitk_plain` is its arithmetic.
- ``tiled``: float32, and bf16 of other widths or alignments (64x64
  tiles, WMMA over hi/lo rows in bf16, FMA in fp32).

The ``wgmma`` and ``splitk`` forms run two or three device kernels and take a workspace
from ``torch.empty``; each call counts once in ``rmsnorm_matmul.launches``.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import dtype_code, on_cpu, require

EPS = 1e-6
FORMS = ('tiled', 'splitk', 'wgmma')  # rmsnorm_matmul_plan's numbering


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


QKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def rmsnorm_qkv_hilo_plain(x: torch.Tensor, scale: torch.Tensor,
                           wq: torch.Tensor, wk: torch.Tensor,
                           wv: torch.Tensor, eps: float = EPS) -> QKV:
    """The ``wgmma`` form's arithmetic: ``xn`` in fp32, split into hi =
    bf16(xn) and lo = bf16(xn - hi), then ``hi @ W + lo @ W`` in fp32 and
    one cast to x's dtype."""
    xn = _normed(x, scale, eps)
    hi = xn.to(torch.bfloat16)
    lo = (xn - hi.float()).to(torch.bfloat16)
    return tuple((hi.float() @ w.float() + lo.float() @ w.float()).to(x.dtype)
                 for w in (wq, wk, wv))


def rmsnorm_qkv_splitk_plain(x: torch.Tensor, scale: torch.Tensor,
                             wq: torch.Tensor, wk: torch.Tensor,
                             wv: torch.Tensor, splits: int,
                             eps: float = EPS) -> QKV:
    """The ``splitk`` form's arithmetic, in fp32: d cut into ``splits``
    slices of ``ceil(d / splits)`` (the last may be shorter or empty); per
    slice the partial ``(x * scale)[:, slice] @ W[slice]`` and the row's
    sum of x^2 over the slice; both summed in slice order from zero; then
    times ``rsqrt(sum of x^2 / d + eps)`` (the inverse RMS factors out of
    the product) and one cast to x's dtype."""
    xf = x.float()
    xs = xf * scale.float()
    d = xf.shape[-1]
    step = -(-d // splits)
    cuts = [slice(s * step, (s + 1) * step) for s in range(splits)]
    ssq = torch.zeros(xf.shape[0], dtype=torch.float32)
    for k in cuts:
        ssq = ssq + xf[:, k].square().sum(-1)
    inv = torch.rsqrt(ssq / d + eps)[:, None]
    outs = []
    for w in (wq, wk, wv):
        wf = w.float()
        acc = torch.zeros((xf.shape[0], w.shape[1]), dtype=torch.float32)
        for k in cuts:
            acc = acc + xs[:, k] @ wf[k]
        outs.append((acc * inv).to(x.dtype))
    return tuple(outs)


def _plan(lib, x: torch.Tensor, ws: List[torch.Tensor],
          form: Optional[str]) -> Tuple[int, int]:
    """(form number, workspace bytes) of a call on the card; raises if the
    shape does not allow ``form``."""
    pad = 3 - len(ws)
    need = ctypes.c_longlong(0)
    got = lib.rmsnorm_matmul_plan(
        *[w.data_ptr() for w in ws], *[0] * pad,
        *[w.shape[1] for w in ws], *[0] * pad, len(ws), x.shape[0],
        x.shape[1], dtype_code('rmsnorm_matmul', x),
        -1 if form is None else FORMS.index(form), ctypes.byref(need))
    require(got >= 0, 'rmsnorm_matmul',
            f'form {form!r} does not take x {tuple(x.shape)} {x.dtype} with '
            f'widths {[w.shape[1] for w in ws]}')
    return got, need.value


def _launch(x: torch.Tensor, scale: torch.Tensor, ws: List[torch.Tensor],
            eps: float, form: Optional[str] = None) -> List[torch.Tensor]:
    """One call of the CUDA kernels over 1-3 weight matrices; x (N, d).
    ``form`` (one of :data:`FORMS`) forces a form, for tests and timing;
    None lets the shape choose."""
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
    got, need = _plan(lib, x, ws, form)
    work = torch.empty(need, dtype=torch.uint8, device=x.device)
    build.check(lib.rmsnorm_matmul(x.data_ptr(), scale.data_ptr(), *wp, *op,
                                   *widths, len(ws), N, d, float(eps), code,
                                   got, work.data_ptr(), need,
                                   build.stream_of(x)), name)
    rmsnorm_matmul.launches += 1
    return outs


def rmsnorm_matmul_form(x: torch.Tensor, ws: List[torch.Tensor]) -> str:
    """The form (one of :data:`FORMS`) a call on the card with x (N, d) and
    these weights takes."""
    return FORMS[_plan(build.load('rmsnorm_matmul'), x, ws, None)[0]]


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
