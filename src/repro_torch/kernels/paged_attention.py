"""In-place paged/chunked attention of a whole query chunk, plus the helpers
that view a dense ring cache as identity-table pages.

Port of ``repro/kernels/paged_attention.py::paged_attention`` (Pallas),
with its MLA (``mla_split``) and int8 (``quant``) variants. The CUDA
kernels are in ``repro_torch/csrc/paged_attention.cu``, in two designs,
chosen by dtype and head width alone (never by a failure):

- bf16 q over bf16 K/V pages at a split width (:func:`split_width`: ``d
  % 16 == 0`` and ``d <= 128``, or ``d == 256``; what the engine runs at
  full width) take the split kernel: the slot's
  virtual cache is cut into chunks of a fixed number of keys
  (``paged_attention_split_chunk``, 64), one block per (slot, kv head,
  tile of 64 query rows (16 at d 256, whose value columns the block's
  four warps share), chunk) on the tensor cores (``mma.sync``, K/V by
  ``cp.async``), each writing its fp32 partial softmax (m, l, acc) to a
  workspace; a second launch combines the chunks in order. One call is two
  device kernels and counts as one launch.
  :func:`paged_attention_chunked_plain` mirrors that arithmetic in fp32
  (every form on the split design).
- the int8 form with bf16 q over int8 pages at a split width (what the
  int8 engines run at full width; :func:`quant_split_form`)
  takes the same split kernel with the pages widened to bf16 in shared
  memory, the key scales applied to the scores and the value scales to the
  probabilities in fp32, then the same combine (two device kernels,
  counted as one launch).
- the MLA form with fp32 q over bf16 latent pages at ``r % 16 == 0``,
  ``dr % 16 == 0``, ``r, dr <= 512`` (what the deepseek engine runs at
  full width; :func:`mla_split_form`) takes the same split on its own
  kernel: one block per (slot, tile of 16 query rows, chunk), the scores
  on the tensor cores with q as bf16 hi + lo, the r value columns split
  over the block's warps, then the same combine (two device kernels,
  counted as one launch).
- every other dense case (fp32 pages, mixed dtypes, other widths), the
  other MLA cases (fp32 pages, bf16 q) and the other int8 cases (fp32 q,
  other widths) take the template kernel: one block per (slot, kv head,
  tile of the T·G query rows) walks the slot's pages through the table
  with an fp32 online softmax, so any chunk length and group size fit one
  launch. The MLA and
  int8 forms are their own wrappers, :func:`paged_attention_mla` and
  :func:`paged_attention_quant`, each with its own launch count.

Contract (as the JAX kernel): q (B, T, KV, G, dq) post-RoPE queries, lane t
at position ``pos0 + t``; k/v pages (NP, ps, KV, d); stored positions
(NP, ps) int32 (-1 = empty); table (B, P) int32; pos0 (B,) int32
-> (B, T, KV, G, dv) in q's dtype. A key is valid for lane t iff its stored
position c has ``c >= 0``, ``c <= pos0 + t`` and, with a window,
``pos0 + t - c < window``; a lane with no valid key gives zeros.

MLA form (``mla_split = r``): KV == 1, q rows are ``[q_abs (r) | q_pe
(dr)]``, ``k_pages`` hold the latent ``ckv`` (NP, ps, 1, r), ``k2_pages``
the rotary keys ``kpe`` (NP, ps, 1, dr), scores are ``q_abs·ckv +
q_pe·kpe`` and the values are the ckv rows again; out (B, T, 1, H, r).
q and the pages may differ in dtype (the MLA attend passes fp32 queries
over bf16 pages); the kernels compute in fp32.

int8 form: int8 k/v pages with bf16 scales ``k_scale_pages`` /
``v_scale_pages`` (NP, ps, KV), one per (token, kv head); scores are
``(q·k)·k_scale·scale``, the running sum ``l`` takes the probabilities
``p`` and the value mix ``p·v_scale`` (the JAX kernel's order); q stays in
its own dtype (bf16 or fp32), and so does the output.

Over a ``('pool', 'heads')`` serving mesh, :func:`sharded_paged_attention`
splits one call over kv heads: each head shard runs the same kernel on its
device's copy of the queries and pages, bitwise equal to one unsharded
call (port of the JAX ``shard_map`` of the kernel).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import dtype_code, on_cpu, require

# kernel forms (csrc/paged_attention.cu), for paged_attention_smem
FORM_DENSE, FORM_MLA, FORM_QUANT = 0, 1, 2
NEG_INF = -2.0 ** 30                    # the kernels' initial running max


def split_width(d: int) -> bool:
    """Head widths the split kernels are built for: multiples of 16 up to
    128 (a warp owns a tile's rows and all its value columns), and 256
    (gemma3-1b: four warps share a tile, 64 value columns each)."""
    return (d % 16 == 0 and d <= 128) or d == 256


def split_form(q: torch.Tensor, k_pages: torch.Tensor,
               v_pages: torch.Tensor) -> bool:
    """Whether a dense-form call on the card takes the split kernel: q and
    both page leaves bf16 at a :func:`split_width`."""
    return (q.dtype == k_pages.dtype == v_pages.dtype == torch.bfloat16
            and split_width(q.shape[-1]))


def quant_split_form(q: torch.Tensor, k_pages: torch.Tensor) -> bool:
    """Whether an int8-form call on the card takes the split kernel: bf16
    q over int8 pages at a :func:`split_width`."""
    return (q.dtype == torch.bfloat16 and k_pages.dtype == torch.int8
            and split_width(q.shape[-1]))


MLA_SPLIT_MAX = 512                     # r and dr of the MLA split kernel


def mla_split_form(q: torch.Tensor, ckv_pages: torch.Tensor,
                   kpe_pages: torch.Tensor) -> bool:
    """Whether an MLA-form call on the card takes the split kernel: fp32 q
    over bf16 ckv and kpe pages, ``r`` and ``dr`` multiples of 16 and at
    most 512."""
    r, dr = ckv_pages.shape[-1], kpe_pages.shape[-1]
    return (q.dtype == torch.float32
            and ckv_pages.dtype == kpe_pages.dtype == torch.bfloat16
            and r % 16 == 0 and dr % 16 == 0
            and r <= MLA_SPLIT_MAX and dr <= MLA_SPLIT_MAX)


def page_validity(cpos: torch.Tensor, pos_t: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Stored positions (..., S) x query positions (..., T) -> (..., T, S)."""
    c = cpos[..., None, :]
    p = pos_t[..., :, None]
    v = (c >= 0) & (c <= p)
    if window:
        v &= (p - c) < window
    return v


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: Optional[torch.Tensor],
                          cpos_pages: torch.Tensor, table: torch.Tensor,
                          pos0: torch.Tensor, *, scale: float,
                          window: int = 0,
                          k2_pages: Optional[torch.Tensor] = None,
                          k_scale_pages: Optional[torch.Tensor] = None,
                          v_scale_pages: Optional[torch.Tensor] = None,
                          mla_split: int = 0) -> torch.Tensor:
    """The kernels' plain version: gather each slot's pages into a dense
    virtual cache, then masked fp32 softmax attention (mirrors the JAX
    oracle ``ref.paged_attention_ref``, MLA and int8 forms included)."""
    B, T = q.shape[:2]
    P, ps = table.shape[1], k_pages.shape[1]
    tab = table.long()

    def virt(pages):                                   # (B, P*ps, ...)
        return pages[tab].reshape((B, P * ps) + tuple(pages.shape[2:]))

    cp = virt(cpos_pages)                                        # (B, S)
    pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
    qf = q.float()
    if mla_split:
        k1 = virt(k_pages).float()                               # (B,S,1,r)
        s = torch.einsum('btkgd,bskd->bkgts', qf[..., :mla_split], k1) \
            + torch.einsum('btkgd,bskd->bkgts', qf[..., mla_split:],
                           virt(k2_pages).float())
        v = k1
    else:
        s = torch.einsum('btkgd,bskd->bkgts', qf, virt(k_pages).float())
        if k_scale_pages is not None:
            ks = virt(k_scale_pages).float()                     # (B,S,KV)
            s = s * ks.transpose(1, 2)[:, :, None, None, :]
        v = virt(v_pages).float()
    s = s * scale
    valid = page_validity(cp, pos_t, window)[:, None, None]      # (B,1,1,T,S)
    s = s.masked_fill(~valid, float('-inf'))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros((), device=q.device))  # empty -> 0
    if v_scale_pages is not None:
        vs = virt(v_scale_pages).float()
        p = p * vs.transpose(1, 2)[:, :, None, None, :]
    o = torch.einsum('bkgts,bskd->btkgd', p, v)
    return o.to(q.dtype)


def paged_attention_chunked_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: Optional[torch.Tensor],
                                  cpos_pages: torch.Tensor,
                                  table: torch.Tensor, pos0: torch.Tensor, *,
                                  scale: float, window: int = 0,
                                  chunk: int,
                                  k2_pages: Optional[torch.Tensor] = None,
                                  k_scale_pages: Optional[torch.Tensor] = None,
                                  v_scale_pages: Optional[torch.Tensor] = None,
                                  mla_split: int = 0) -> torch.Tensor:
    """The split kernels' arithmetic, in fp32, for the dense form, (with
    ``mla_split = r`` and ``k2_pages``, as :func:`paged_attention_plain`)
    the MLA form and (with the scale pages) the int8 form (no path runs it;
    the tests hold it against :func:`paged_attention_plain` and the JAX
    oracle). The slot's virtual cache is cut at multiples of ``chunk`` keys;
    per chunk and query row the partial ``m`` (max of the usable scores,
    ``NEG_INF`` if none), ``l = sum exp(s - m)`` and ``acc = sum exp(s - m)
    v``; then, over the chunks with ``l > 0``, ``m* = max m``, ``l* = sum l
    e^(m - m*)`` and ``out = sum acc e^(m - m*) / max(l*, 1e-30)``, in q's
    dtype. The int8 form scores ``(q·k)·k_scale·scale`` and takes ``p`` into
    ``l`` and ``p·v_scale`` into ``acc``."""
    B, T, KV, G, _ = q.shape
    P, ps = table.shape[1], k_pages.shape[1]
    S = P * ps
    nch = -(-S // chunk)
    pad = nch * chunk - S
    tab = table.long()

    def virt(pages, fill):                    # (B, nch * chunk, ...)
        x = pages[tab].reshape((B, S) + tuple(pages.shape[2:]))
        return torch.cat([x, x.new_full((B, pad) + x.shape[2:], fill)], 1)

    cp = virt(cpos_pages, -1)
    kf = virt(k_pages, 0).float()
    qf = q.float()
    if mla_split:             # scores [q_abs | q_pe]·[ckv | kpe], values ckv
        s = torch.einsum('btkgd,bskd->bkgts', qf[..., :mla_split], kf) \
            + torch.einsum('btkgd,bskd->bkgts', qf[..., mla_split:],
                           virt(k2_pages, 0).float())
        vf = kf
    else:
        s = torch.einsum('btkgd,bskd->bkgts', qf, kf)
        vf = virt(v_pages, 0).float()

    def per_key(scales):                      # (B, KV, 1, 1, nch, chunk)
        return virt(scales, 0).float().transpose(1, 2) \
            .reshape(B, KV, 1, 1, nch, chunk)
    vf = vf.view((B, nch, chunk) + tuple(vf.shape[2:]))
    pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
    valid = page_validity(cp, pos_t, window).view(B, 1, 1, T, nch, chunk)
    s = s.view(B, KV, G, T, nch, chunk)
    if k_scale_pages is not None:
        s = s * per_key(k_scale_pages)
    s = (s * scale).masked_fill(~valid, NEG_INF)
    m = s.amax(-1)                                       # (B,KV,G,T,nch)
    zero = torch.zeros((), device=q.device)
    p = torch.where(valid, torch.exp(s - m[..., None]), zero)
    l = p.sum(-1)
    if v_scale_pages is not None:
        p = p * per_key(v_scale_pages)
    acc = torch.einsum('bkgtnc,bnckd->bkgtnd', p, vf)
    live = l > 0
    m_star = torch.where(live, m, NEG_INF).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - m_star), zero)
    o = (acc * w[..., None]).sum(-2) \
        / (l * w).sum(-1).clamp_min(1e-30)[..., None]       # (B,KV,G,T,dv)
    return o.permute(0, 3, 1, 2, 4).to(q.dtype)


def _check_common(name: str, q: torch.Tensor, cpos_pages: torch.Tensor,
                  table: torch.Tensor, pos0: torch.Tensor, NP: int,
                  ps: int) -> None:
    B = q.shape[0]
    require(cpos_pages.shape == (NP, ps) and cpos_pages.dtype == torch.int32,
            name, 'cpos pages must be (NP, ps) int32')
    require(table.dim() == 2 and table.shape[0] == B
            and table.dtype == torch.int32, name, 'table must be (B, P) int32')
    require(pos0.shape == (B,) and pos0.dtype == torch.int32, name,
            'pos0 must be (B,) int32')


def _check_kv_types(name: str, k_pages: torch.Tensor,
                    k_scale_pages: Optional[torch.Tensor],
                    v_scale_pages: Optional[torch.Tensor]) -> None:
    """int8 pages come with both scale leaves and only they do, on the CPU
    as on the card: an int8 cache never runs without its scales."""
    int8 = k_pages.dtype == torch.int8
    scales = (k_scale_pages is not None, v_scale_pages is not None)
    require(not int8 or all(scales), name,
            'int8 K/V pages need k_scale_pages and v_scale_pages '
            '(paged_attention_quant)')
    require(int8 or not any(scales), name,
            f'scales go with int8 K/V pages only, got {k_pages.dtype} pages')


def _check_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for nm, t in tensors.items():
        require(t.is_contiguous(), name, f'{nm} must be contiguous')


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: Optional[torch.Tensor],
                    cpos_pages: torch.Tensor, table: torch.Tensor,
                    pos0: torch.Tensor, *, scale: float, window: int = 0,
                    k2_pages: Optional[torch.Tensor] = None,
                    mla_split: int = 0) -> torch.Tensor:
    """See the module docstring. ``mla_split`` goes to
    :func:`paged_attention_mla`. CPU tensors take
    :func:`paged_attention_plain`; CUDA tensors launch a dense-form kernel
    (q in float32 or bfloat16; K and V pages share one of those dtypes):
    the split kernel and its combine where :func:`split_form` holds (bf16 q
    and pages at a split width; q and pages 16-byte aligned), else
    the template kernel. Counts calls in ``paged_attention.launches``, one
    a call whichever kernel runs."""
    if mla_split:
        require(v_pages is None and k2_pages is not None
                and k_pages.shape[-1] == mla_split, 'paged_attention_mla',
                'the MLA form takes ckv pages of width mla_split as k_pages, '
                'kpe pages as k2_pages and no v_pages')
        return paged_attention_mla(q, k_pages, k2_pages, cpos_pages, table,
                                   pos0, scale=scale, window=window)
    name = 'paged_attention'
    _check_kv_types(name, k_pages, None, None)
    if on_cpu(name, q, k_pages, v_pages, cpos_pages, table, pos0):
        return paged_attention_plain(q, k_pages, v_pages, cpos_pages, table,
                                     pos0, scale=scale, window=window)
    require(q.dim() == 5, name, f'q must be (B, T, KV, G, d), got '
            f'{tuple(q.shape)}')
    B, T, KV, G, d = q.shape
    NP, ps = k_pages.shape[:2]
    require(k_pages.shape == (NP, ps, KV, d) and v_pages.shape == k_pages.shape,
            name, f'k/v pages must be (NP, ps, {KV}, {d}), got '
            f'{tuple(k_pages.shape)} / {tuple(v_pages.shape)}')
    _check_common(name, q, cpos_pages, table, pos0, NP, ps)
    require(v_pages.dtype == k_pages.dtype, name,
            f'K and V pages must share a dtype, got {k_pages.dtype}, '
            f'{v_pages.dtype}')
    _check_contiguous(name, q=q, k_pages=k_pages, v_pages=v_pages,
                      cpos_pages=cpos_pages, table=table, pos0=pos0)
    codes = dtype_code(name, q), dtype_code(name, k_pages)
    lib = build.load(name)
    P = table.shape[1]
    out = torch.empty_like(q)
    if split_form(q, k_pages, v_pages):
        require(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
                name, 'bf16 q and K/V pages must be 16-byte aligned')
        R, S = T * G, P * ps
        nch = -(-S // lib.paged_attention_split_chunk(B, KV, R, S))
        ws = torch.empty(B * KV * nch * R * (d + 2), dtype=torch.float32,
                         device=q.device)
        build.check(lib.paged_attention_split(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            cpos_pages.data_ptr(), table.data_ptr(), pos0.data_ptr(),
            ws.data_ptr(), out.data_ptr(), B, T, KV, G, d, NP, ps, P,
            float(scale), int(window), build.stream_of(q)), name)
    else:
        require(lib.paged_attention_smem(T * G, d, d, FORM_DENSE) > 0, name,
                f'a tile of query rows of width {d} exceeds one block\'s '
                'shared memory')
        build.check(lib.paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            cpos_pages.data_ptr(), table.data_ptr(), pos0.data_ptr(),
            out.data_ptr(), B, T, KV, G, d, NP, ps, P, float(scale),
            int(window), *codes, build.stream_of(q)), name)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_mla(q: torch.Tensor, ckv_pages: torch.Tensor,
                        kpe_pages: torch.Tensor, cpos_pages: torch.Tensor,
                        table: torch.Tensor, pos0: torch.Tensor, *,
                        scale: float, window: int = 0) -> torch.Tensor:
    """The MLA form: q (B, T, 1, H, r + dr) rows ``[q_abs | q_pe]``, ckv
    pages (NP, ps, 1, r), kpe pages (NP, ps, 1, dr) -> (B, T, 1, H, r) in
    q's dtype. CPU tensors take :func:`paged_attention_plain` with
    ``mla_split = r``; CUDA tensors launch an MLA kernel (q in float32 or
    bfloat16; ckv and kpe pages share one of those dtypes): the split
    kernel and its combine where :func:`mla_split_form` holds (fp32 q over
    bf16 pages; q and pages 16-byte aligned), else the template kernel.
    Counts calls in ``paged_attention_mla.launches``, one a call whichever
    kernel runs."""
    name = 'paged_attention_mla'
    r = ckv_pages.shape[-1]
    if on_cpu(name, q, ckv_pages, kpe_pages, cpos_pages, table, pos0):
        return paged_attention_plain(q, ckv_pages, None, cpos_pages, table,
                                     pos0, scale=scale, window=window,
                                     k2_pages=kpe_pages, mla_split=r)
    require(q.dim() == 5 and q.shape[2] == 1, name,
            f'q must be (B, T, 1, H, r + dr), got {tuple(q.shape)}')
    B, T, _, H, dq = q.shape
    NP, ps = ckv_pages.shape[:2]
    dr = dq - r
    require(ckv_pages.shape == (NP, ps, 1, r) and dr > 0
            and kpe_pages.shape == (NP, ps, 1, dr), name,
            f'ckv / kpe pages must be (NP, ps, 1, r) / (NP, ps, 1, dr) with '
            f'r + dr = {dq}, got {tuple(ckv_pages.shape)} / '
            f'{tuple(kpe_pages.shape)}')
    _check_common(name, q, cpos_pages, table, pos0, NP, ps)
    require(kpe_pages.dtype == ckv_pages.dtype, name,
            f'ckv and kpe pages must share a dtype, got {ckv_pages.dtype}, '
            f'{kpe_pages.dtype}')
    _check_contiguous(name, q=q, ckv_pages=ckv_pages, kpe_pages=kpe_pages,
                      cpos_pages=cpos_pages, table=table, pos0=pos0)
    codes = dtype_code(name, q), dtype_code(name, ckv_pages)
    lib = build.load('paged_attention')
    P = table.shape[1]
    out = torch.empty((B, T, 1, H, r), dtype=q.dtype, device=q.device)
    if mla_split_form(q, ckv_pages, kpe_pages):
        require(all(t.data_ptr() % 16 == 0 for t in (q, ckv_pages,
                                                       kpe_pages)),
                name, 'fp32 q and bf16 ckv / kpe pages must be 16-byte '
                'aligned')
        R, S = T * H, P * ps
        nch = -(-S // lib.paged_attention_split_chunk(B, 1, R, S))
        ws = torch.empty(B * nch * R * (r + 2), dtype=torch.float32,
                         device=q.device)
        build.check(lib.paged_attention_mla_split(
            q.data_ptr(), ckv_pages.data_ptr(), kpe_pages.data_ptr(),
            cpos_pages.data_ptr(), table.data_ptr(), pos0.data_ptr(),
            ws.data_ptr(), out.data_ptr(), B, T, H, r, dr, NP, ps, P,
            float(scale), int(window), build.stream_of(q)), name)
    else:
        require(lib.paged_attention_smem(T * H, dq, r, FORM_MLA) > 0, name,
                f'a tile of query rows of width {dq} exceeds one block\'s '
                'shared memory')
        build.check(lib.paged_attention_mla(
            q.data_ptr(), ckv_pages.data_ptr(), kpe_pages.data_ptr(),
            cpos_pages.data_ptr(), table.data_ptr(), pos0.data_ptr(),
            out.data_ptr(), B, T, H, r, dr, NP, ps, P, float(scale),
            int(window), *codes, build.stream_of(q)), name)
    paged_attention_mla.launches += 1
    return out


paged_attention_mla.launches = 0


def paged_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, k_scale_pages: torch.Tensor,
                          v_scale_pages: torch.Tensor,
                          cpos_pages: torch.Tensor, table: torch.Tensor,
                          pos0: torch.Tensor, *, scale: float,
                          window: int = 0) -> torch.Tensor:
    """The int8 form: q (B, T, KV, G, d) in float32 or bfloat16, int8 k/v
    pages (NP, ps, KV, d), bf16 scales (NP, ps, KV) -> (B, T, KV, G, d) in
    q's dtype. CPU tensors take :func:`paged_attention_plain` with the
    scales; CUDA tensors launch an int8 kernel: the split kernel and its
    combine where :func:`quant_split_form` holds (bf16 q at a split width;
    q and pages 16-byte aligned), else the template kernel. Counts
    calls in ``paged_attention_quant.launches``, one a call whichever
    kernel runs."""
    name = 'paged_attention_quant'
    _check_kv_types(name, k_pages, k_scale_pages, v_scale_pages)
    if on_cpu(name, q, k_pages, v_pages, k_scale_pages, v_scale_pages,
              cpos_pages, table, pos0):
        return paged_attention_plain(q, k_pages, v_pages, cpos_pages, table,
                                     pos0, scale=scale, window=window,
                                     k_scale_pages=k_scale_pages,
                                     v_scale_pages=v_scale_pages)
    require(q.dim() == 5, name, f'q must be (B, T, KV, G, d), got '
            f'{tuple(q.shape)}')
    B, T, KV, G, d = q.shape
    NP, ps = k_pages.shape[:2]
    require(k_pages.shape == (NP, ps, KV, d) and v_pages.shape == k_pages.shape
            and v_pages.dtype == torch.int8, name,
            f'k/v pages must be int8 (NP, ps, {KV}, {d}), got '
            f'{tuple(k_pages.shape)} / {tuple(v_pages.shape)} {v_pages.dtype}')
    for nm, sc in (('k_scale_pages', k_scale_pages),
                   ('v_scale_pages', v_scale_pages)):
        require(sc.shape == (NP, ps, KV) and sc.dtype == torch.bfloat16, name,
                f'{nm} must be bfloat16 (NP, ps, {KV}), got '
                f'{tuple(sc.shape)} {sc.dtype}')
    _check_common(name, q, cpos_pages, table, pos0, NP, ps)
    _check_contiguous(name, q=q, k_pages=k_pages, v_pages=v_pages,
                      k_scale_pages=k_scale_pages,
                      v_scale_pages=v_scale_pages, cpos_pages=cpos_pages,
                      table=table, pos0=pos0)
    code = dtype_code(name, q)
    lib = build.load('paged_attention')
    P = table.shape[1]
    out = torch.empty_like(q)
    if quant_split_form(q, k_pages):
        require(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
                name, 'bf16 q and int8 K/V pages must be 16-byte aligned')
        R, S = T * G, P * ps
        nch = -(-S // lib.paged_attention_split_chunk(B, KV, R, S))
        ws = torch.empty(B * KV * nch * R * (d + 2), dtype=torch.float32,
                         device=q.device)
        build.check(lib.paged_attention_quant_split(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale_pages.data_ptr(), v_scale_pages.data_ptr(),
            cpos_pages.data_ptr(), table.data_ptr(), pos0.data_ptr(),
            ws.data_ptr(), out.data_ptr(), B, T, KV, G, d, NP, ps, P,
            float(scale), int(window), build.stream_of(q)), name)
    else:
        require(lib.paged_attention_smem(T * G, d, d, FORM_QUANT) > 0, name,
                f'a tile of query rows of width {d} exceeds one block\'s '
                'shared memory')
        build.check(lib.paged_attention_quant(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale_pages.data_ptr(), v_scale_pages.data_ptr(),
            cpos_pages.data_ptr(), table.data_ptr(), pos0.data_ptr(),
            out.data_ptr(), B, T, KV, G, d, NP, ps, P, float(scale),
            int(window), code, build.stream_of(q)), name)
    paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0



# ================================================== head-parallel over a mesh
def _head_shards(mesh, q, k_pages, v_pages, cpos_pages, table, pos0,
                 k_scale_pages, v_scale_pages):
    """Per head shard h: (``mesh.devices[0][h]``, its arguments there) —
    q's and each K/V (and scale) leaf's contiguous slice of kv heads
    ``h*KV/H : (h+1)*KV/H``, and device-local copies of the positions,
    the table and pos0."""
    H = mesh.shape[1]
    per = q.shape[2] // H
    for h in range(H):
        dev = mesh.devices[0][h]

        def part(x, dim):
            return x.narrow(dim, h * per, per).to(dev).contiguous()
        scales = None if k_scale_pages is None else \
            (part(k_scale_pages, 2), part(v_scale_pages, 2))
        yield dev, (part(q, 2), part(k_pages, 2), part(v_pages, 2),
                    cpos_pages.to(dev), table.to(dev), pos0.to(dev)), scales


def _unsharded(mesh, q, mla_split) -> bool:
    """JAX's fallbacks: no mesh, a heads axis of 1, MLA (one latent head),
    kv heads that the heads axis does not divide. Raises ValueError for a
    mesh on another type of device than q's."""
    if mesh is not None and mesh.primary.type != q.device.type:
        raise ValueError(f'mesh devices are {mesh.primary.type}, the '
                         f'queries are on {q.device}')
    H = 1 if mesh is None else mesh.shape[1]
    return H == 1 or bool(mla_split) or q.shape[2] % H != 0


def sharded_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: Optional[torch.Tensor],
                            cpos_pages: torch.Tensor, table: torch.Tensor,
                            pos0: torch.Tensor, *, mesh, scale: float,
                            window: int = 0,
                            k2_pages: Optional[torch.Tensor] = None,
                            k_scale_pages: Optional[torch.Tensor] = None,
                            v_scale_pages: Optional[torch.Tensor] = None,
                            mla_split: int = 0) -> torch.Tensor:
    """Head-parallel :func:`paged_attention` over a ``('pool', 'heads')``
    mesh (``launch.mesh.ServingMesh``); port of the JAX package's
    ``sharded_paged_attention``, whose ``shard_map`` over ``'heads'`` this
    dispatch replaces.

    Every kv head's running softmax is independent, so kv-head shard ``h``
    runs the unsharded kernel (:func:`paged_attention`, or
    :func:`paged_attention_quant` with the int8 scales) on ``KV / H`` heads
    on ``mesh.devices[0][h]``, with device-local copies of the table, the
    stored positions and pos0; the outputs are joined along the kv-head
    axis on q's device. No reduction crosses a shard, so the result is
    bitwise the unsharded kernel's. Falls back to one unsharded call
    without a mesh, with a heads axis of 1, for MLA (``mla_split``), and
    when the heads axis does not divide KV.

    Each shard's launch is the unsharded kernel's at KV / H heads, as bound
    as that kernel (few blocks at decode shapes); on one card repeated in
    the mesh the H launches run one after another, and the slices' copies
    come on top (PERF.md row 3b).

    CPU tensors take the plain version in every shard; CUDA tensors launch
    the kernel in every shard or raise. Counts the shard launches in
    ``sharded_paged_attention.launches`` (each also counts in its kernel's
    own count); a fallback counts only there."""
    quant = k_scale_pages is not None
    if _unsharded(mesh, q, mla_split):
        if quant:
            return paged_attention_quant(q, k_pages, v_pages, k_scale_pages,
                                         v_scale_pages, cpos_pages, table,
                                         pos0, scale=scale, window=window)
        return paged_attention(q, k_pages, v_pages, cpos_pages, table, pos0,
                               scale=scale, window=window, k2_pages=k2_pages,
                               mla_split=mla_split)
    outs = []
    for dev, (qh, kh, vh, cp, tab, p0), scales in _head_shards(
            mesh, q, k_pages, v_pages, cpos_pages, table, pos0,
            k_scale_pages, v_scale_pages):
        with torch.cuda.device(dev) if dev.type == 'cuda' \
                else contextlib.nullcontext():
            if quant:
                o = paged_attention_quant(qh, kh, vh, *scales, cp, tab, p0,
                                          scale=scale, window=window)
            else:
                o = paged_attention(qh, kh, vh, cp, tab, p0, scale=scale,
                                    window=window)
        if o.is_cuda:
            sharded_paged_attention.launches += 1
        outs.append(o.to(q.device))
    return torch.cat(outs, dim=2)


sharded_paged_attention.launches = 0


def sharded_paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: Optional[torch.Tensor],
                                  cpos_pages: torch.Tensor,
                                  table: torch.Tensor, pos0: torch.Tensor, *,
                                  mesh, scale: float, window: int = 0,
                                  k2_pages: Optional[torch.Tensor] = None,
                                  k_scale_pages: Optional[torch.Tensor] = None,
                                  v_scale_pages: Optional[torch.Tensor] = None,
                                  mla_split: int = 0) -> torch.Tensor:
    """:func:`sharded_paged_attention`'s plain version: the same split (and
    the same fallbacks) over :func:`paged_attention_plain`, on any
    device."""
    if _unsharded(mesh, q, mla_split):
        return paged_attention_plain(q, k_pages, v_pages, cpos_pages, table,
                                     pos0, scale=scale, window=window,
                                     k2_pages=k2_pages,
                                     k_scale_pages=k_scale_pages,
                                     v_scale_pages=v_scale_pages,
                                     mla_split=mla_split)
    outs = []
    for _, (qh, kh, vh, cp, tab, p0), scales in _head_shards(
            mesh, q, k_pages, v_pages, cpos_pages, table, pos0,
            k_scale_pages, v_scale_pages):
        ks, vs = scales if scales is not None else (None, None)
        outs.append(paged_attention_plain(
            qh, kh, vh, cp, tab, p0, scale=scale, window=window,
            k_scale_pages=ks, v_scale_pages=vs).to(q.device))
    return torch.cat(outs, dim=2)

# ========================================== dense caches as identity pages
def dense_page_split(Sc: int, max_page: int = 128) -> int:
    """Page size for viewing a dense (B, Sc, ...) cache as pages in place:
    the largest power of two <= ``max_page`` that divides Sc (1 for odd
    ring lengths, which the kernel handles at the same cost)."""
    for bs in (max_page, 64, 32, 16, 8, 4, 2):
        if bs <= Sc and Sc % bs == 0:
            return bs
    return 1


def dense_as_pages(leaf: torch.Tensor, ps: int) -> torch.Tensor:
    """(B, Sc, ...) -> (B * Sc/ps, ps, ...) page view — no copy."""
    B, Sc = leaf.shape[:2]
    return leaf.view((B * (Sc // ps), ps) + tuple(leaf.shape[2:]))


def dense_identity_table(B: int, Sc: int, ps: int,
                         device: torch.device | str = 'cpu') -> torch.Tensor:
    """Page table mapping slot b's block j to physical page b * P + j."""
    P = Sc // ps
    return torch.arange(B * P, dtype=torch.int32, device=device).view(B, P)
