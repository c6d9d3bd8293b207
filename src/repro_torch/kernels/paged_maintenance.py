"""Paged-pool maintenance: the chunk K/V scatter with deferred
clear-on-alloc, and copy-on-write of one page into another.

Port of ``repro/kernels/paged_maintenance.py`` (Pallas). The CUDA kernels
are ``repro_torch/csrc/fused_page_write.cu`` and
``repro_torch/csrc/cow_page_copy.cu``; both update the pool tensors in
place.

Job list (``NJ, 6`` int32, from :func:`build_jobs`): ``[page, slot, delta,
nv, mode, vbase]``. Row ``r`` of the page holds chunk lane ``t = (delta +
r) mod Sc``; it is written iff ``t < nv`` and ``vbase + r < Sc`` (``vbase``
is the block's first virtual index: ring lengths need not be page
multiples). ``mode``: 0 = merge into the page, 1 = the page is fresh
(pending clear), so unwritten rows get the fill value, 2 = clear the whole
page (``nv == 0``). Jobs may name the same page only where every such job
writes the same bytes: merge pages are distinct within a slot and private
to it, a pending page's clear job is demoted to the null page 0 when a
merge job covers the page, and page 0 always holds the fill value.

Unlike the Pallas kernel, the CUDA kernel writes only the rows a job
changes and never copies a page back, and one launch writes every leaf of
a layer's cache (k, v, the int8 cache's k_scale / v_scale, and the
position leaf) from the shared job list. For an int8 cache it takes the
float K/V chunk values and quantizes them in the same launch (JAX runs its
``_quantize`` as XLA ops in front of the Pallas kernel); the plain version
is :func:`quantize_rows` followed by :func:`fused_page_write_plain`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import dtype_code, on_cpu, require

MODE_MERGE = 0
MODE_FRESH = 1
MODE_CLEAR = 2
MAX_LEAVES = 6       # leaves per launch (csrc kMaxLeaves)


def leaf_fill(name: str) -> int:
    """Clear value for a pool leaf: positions use -1 (= never written)."""
    return -1 if name == 'pos' else 0


def build_jobs(pos0: torch.Tensor, n_valid: torch.Tensor,
               table: torch.Tensor, Sc: int, ps: int, T: int,
               pending: torch.Tensor) -> torch.Tensor:
    """Job list for one chunk write plus pending clears (as the JAX
    ``build_jobs``): pos0 (B,), n_valid (B,), table (B, P), pending (K,)
    physical pages awaiting clear-on-alloc (0 = padding) -> jobs
    (K + B*NJm, 6) int32 on the tables' device.

    A chunk of T tokens touches at most ``T // ps + 3`` consecutive
    logical blocks, so NJm candidate merge jobs per slot cover every
    written page; candidates past the written range write nothing. A
    candidate whose page is pending is marked fresh (mode 1) and that
    page's clear job is demoted to the page-0 no-op.
    """
    B, P = table.shape
    dev = table.device
    NJm = min(T // ps + 3, P)
    i = torch.arange(NJm, dtype=torch.int32, device=dev)
    pos0 = pos0.to(torch.int32)
    start_blk = torch.div(pos0 % Sc, ps, rounding_mode='floor')
    lb = (start_blk[:, None] + i[None, :]) % P                 # (B, NJm)
    page = torch.gather(table.to(torch.int32), 1, lb.long())
    delta = (lb * ps - pos0[:, None]) % Sc
    nv = n_valid.to(torch.int32)[:, None].expand(B, NJm)
    slot = torch.arange(B, dtype=torch.int32, device=dev)[:, None] \
        .expand(B, NJm)
    pend = pending.to(torch.int32)                             # (K,)
    fresh = ((page[:, :, None] == pend[None, None, :])
             & (pend[None, None, :] > 0)).any(-1)
    mode = torch.where(fresh, MODE_FRESH, MODE_MERGE).to(torch.int32)
    merge = torch.stack([page, slot, delta, nv, mode, lb * ps], dim=-1) \
        .reshape(B * NJm, 6)
    covered = (pend[:, None] == page.reshape(-1)[None, :]).any(-1)
    cpage = torch.where(covered, torch.zeros_like(pend), pend)
    z = torch.zeros_like(pend)
    clear = torch.stack([cpage, z, z, z, torch.full_like(pend, MODE_CLEAR),
                         z], dim=-1)
    return torch.cat([clear, merge], dim=0).contiguous()


def chunk_positions(pos0: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) int32 absolute positions of a chunk's lanes: the values of
    the position leaf."""
    return (pos0.to(torch.int32)[:, None]
            + torch.arange(T, dtype=torch.int32, device=pos0.device)[None])


# ========================================================= fused_page_write
def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 values + bf16 symmetric scale per row (...),
    bitwise as JAX's ``_quantize``: the amax and the division in fp32 by
    the fp32 scale, round half to even, then the scale stored as bf16.
    The quantizing form of :func:`fused_page_write` computes it in its
    launch, as this code runs on the card."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def quantized_values(vals: Sequence[Optional[torch.Tensor]],
                     quantize: Sequence[Tuple[int, int]]
                     ) -> List[torch.Tensor]:
    """``vals`` with each ``(value leaf, scale leaf)`` pair of ``quantize``
    filled in by :func:`quantize_rows` of the value leaf's float rows: the
    chunk values the plain write stores."""
    out = list(vals)
    for i, j in quantize:
        out[i], out[j] = quantize_rows(vals[i])
    return out


def fused_page_write_plain(pool: torch.Tensor, vals: torch.Tensor,
                           jobs: torch.Tensor, *, Sc: int,
                           fill: int = 0) -> torch.Tensor:
    """Apply a job list to one pool leaf in place — the kernel's plain
    version, with JAX's ``fused_page_write`` semantics: each job's page is
    rebuilt whole (written rows, fill rows, old rows) and stored back.
    pool (NP, ps, ...), vals (B, T, ...) -> pool."""
    ps, T = pool.shape[1], vals.shape[1]
    page, slot, delta, nv, mode, vbase = jobs.long().unbind(1)
    r = torch.arange(ps, device=pool.device)
    t = delta[:, None] + r[None]
    t = torch.where(t >= Sc, t - Sc, t)
    written = (t < nv[:, None]) & ((vbase[:, None] + r[None]) < Sc)
    bshape = written.shape + (1,) * (pool.dim() - 2)
    new = vals[slot[:, None], t.clamp(max=T - 1)].to(pool.dtype)
    base = torch.where((mode >= MODE_FRESH).view(-1, *(1,) * (pool.dim() - 1)),
                       torch.full((), fill, dtype=pool.dtype,
                                  device=pool.device), pool[page])
    pool[page] = torch.where(written.view(bshape), new, base)
    return pool


def _fill_bits(t: torch.Tensor, fill: int) -> int:
    """The fill value's bytes in ``t``'s dtype, repeated to 32 bits."""
    raw = torch.tensor([fill], dtype=t.dtype).view(torch.uint8).tolist()
    return int.from_bytes(bytes(raw) * (4 // len(raw)), 'little')


def _element_ok(name: str, t: torch.Tensor) -> None:
    require(t.element_size() in (1, 2, 4), name,
            f'elements of 1, 2 or 4 bytes, got {t.dtype}')


def fused_page_write(pools: Sequence[torch.Tensor],
                     vals: Sequence[Optional[torch.Tensor]],
                     jobs: torch.Tensor, *, Sc: int, fills: Sequence[int],
                     quantize: Sequence[Tuple[int, int]] = ()
                     ) -> List[torch.Tensor]:
    """Apply one job list to every pool leaf of a layer, in place.

    ``pools[i]`` (NP, ps, ...) contiguous takes chunk values ``vals[i]``
    (B, T, ...) (same trailing shape and dtype; the trailing axes of each
    (b, t) row contiguous) and fill value ``fills[i]``. Each ``(i, j)`` of
    ``quantize`` names an int8 value leaf ``pools[i]`` (NP, ps, ..., hd)
    and its bf16 scale leaf ``pools[j]`` (NP, ps, ...): ``vals[i]`` holds
    the float rows (B, T, ..., hd) that are quantized per row of hd
    (:func:`quantize_rows`), and ``vals[j]`` is None. CPU tensors take
    :func:`quantized_values` and :func:`fused_page_write_plain` leaf by
    leaf; CUDA tensors launch the kernel once for all leaves. Counts
    launches in ``fused_page_write.launches``.
    """
    name = 'fused_page_write'
    require(len(pools) == len(vals) == len(fills) and pools, name,
            'one chunk value tensor and one fill per pool leaf')
    scale_of = dict(quantize)
    require(len(scale_of) == len(quantize) and all(
        vals[j] is None and i != j and j not in scale_of
        for i, j in quantize), name,
        'quantize pairs (value leaf, scale leaf) with no chunk values for '
        'the scale leaf')
    given = [v for v in vals if v is not None]
    if on_cpu(name, jobs, *pools, *given):
        for pool, v, f in zip(pools, quantized_values(vals, quantize), fills):
            fused_page_write_plain(pool, v, jobs, Sc=Sc, fill=f)
        return list(pools)
    require(len(pools) <= MAX_LEAVES, name, f'at most {MAX_LEAVES} leaves')
    require(jobs.dim() == 2 and jobs.shape[1] == 6
            and jobs.dtype == torch.int32 and jobs.is_contiguous(), name,
            'jobs must be contiguous (NJ, 6) int32')
    NP, ps = pools[0].shape[:2]
    B, T = given[0].shape[:2]
    scales = set(scale_of.values())
    ptrs, vptrs, strides, row_bytes, fbits, quant = [], [], [], [], [], []
    for i, (pool, v, f) in enumerate(zip(pools, vals, fills)):
        require(pool.shape[:2] == (NP, ps) and pool.is_contiguous(), name,
                f'pool leaves must be contiguous (NP, ps, ...), got '
                f'{tuple(pool.shape)}')
        _element_ok(name, pool)
        ptrs.append(pool.data_ptr())
        row_bytes.append(pool[0, 0].numel() * pool.element_size())
        fbits.append(_fill_bits(pool, f))
        if i in scales:
            require(pool.dtype == torch.bfloat16, name,
                    f'scale leaves are bfloat16, got {pool.dtype}')
            vptrs.append(0)
            strides += [0, 0]
            continue
        quantized = i in scale_of
        want = v.dtype if quantized else pool.dtype
        require(v.shape[:2] == (B, T) and v.shape[2:] == pool.shape[2:]
                and v.dtype == want, name,
                f'chunk values {tuple(v.shape)} {v.dtype} do not match pool '
                f'leaf {tuple(pool.shape)} {pool.dtype}')
        tail = v[0, 0]
        require(tail.is_contiguous(), name,
                'each (b, t) row of the chunk values must be contiguous')
        if quantized:
            sc = pools[scale_of[i]]
            require(pool.dtype == torch.int8 and sc.shape == pool.shape[:-1],
                    name, f'a quantized leaf is int8 (NP, ps, ..., hd) with '
                    f'scales (NP, ps, ...), got {tuple(pool.shape)} '
                    f'{pool.dtype} and {tuple(sc.shape)}')
            quant += [i, scale_of[i], pool.shape[-1],
                      dtype_code(name, v)]
        es = v.element_size()
        vptrs.append(v.data_ptr())
        strides += [v.stride(0) * es, v.stride(1) * es]
    NJ = jobs.shape[0]
    if NJ == 0:
        return list(pools)
    n = len(pools)
    lib = build.load(name)
    build.check(lib.fused_page_write(
        (ctypes.c_void_p * n)(*ptrs), (ctypes.c_void_p * n)(*vptrs),
        (ctypes.c_longlong * (2 * n))(*strides),
        (ctypes.c_int * n)(*row_bytes),
        (ctypes.c_uint * n)(*fbits), n,
        (ctypes.c_int * max(len(quant), 1))(*quant), len(quant) // 4,
        jobs.data_ptr(), NJ, NP, B, ps, int(Sc), build.stream_of(jobs)),
        name)
    fused_page_write.launches += 1
    return list(pools)


fused_page_write.launches = 0


def fused_chunk_scatter(cache: Dict[str, torch.Tensor],
                        vals: Dict[str, torch.Tensor], jobs: torch.Tensor,
                        pos_t: torch.Tensor, *, Sc: int
                        ) -> Dict[str, torch.Tensor]:
    """Chunk write of every ``vals`` leaf plus the position leaf
    (``pos_t``, from :func:`chunk_positions`) through the step's job list
    ``jobs`` (:func:`build_jobs`, shared by every layer), with its pending
    page clears applied to every leaf of ``cache``, in place: bitwise equal
    to clearing the pending pages and then running
    ``attention.paged_scatter``. For an int8 cache (``k_scale`` /
    ``v_scale`` leaves) ``vals`` holds the float ``k`` / ``v`` alone: the
    launch quantizes them (:func:`quantize_rows`)."""
    quant = 'k_scale' in cache
    if quant:
        require(set(vals) == {'k', 'v'} and all(
            v.is_floating_point() for v in vals.values()),
            'fused_chunk_scatter', f'an int8 cache takes the float k / v '
            f'alone, got {sorted((nm, v.dtype) for nm, v in vals.items())}')
        vals = dict(vals, k_scale=None, v_scale=None)
    vals = dict(vals, pos=pos_t)
    names = list(cache)
    require(set(names) == set(vals), 'fused_chunk_scatter',
            f'chunk values {sorted(vals)} must cover every cache leaf '
            f'{sorted(names)}')
    pairs = [(names.index(nm), names.index(nm + '_scale'))
             for nm in ('k', 'v')] if quant else []

    def value(nm):
        if quant and nm != 'pos':
            return vals[nm]     # quantized in the launch, never cast to int8
        return vals[nm].to(cache[nm].dtype)
    fused_page_write([cache[nm] for nm in names], [value(nm) for nm in names],
                     jobs, Sc=Sc, fills=[leaf_fill(nm) for nm in names],
                     quantize=pairs)
    return cache


# ============================================================ cow_page_copy
def cow_page_copy_plain(pool: torch.Tensor, sdr: torch.Tensor, *,
                        fill: int = 0) -> torch.Tensor:
    """Each job ``[src, dst, rem]``: page dst = the first ``rem`` rows of
    page src, the other rows the fill value — in place; the kernel's plain
    version and JAX's ``cow_page_copy`` semantics."""
    ps = pool.shape[1]
    src, dst, rem = sdr.long().unbind(1)
    rows = pool[src]
    keep = torch.arange(ps, device=pool.device)[None] < rem[:, None]
    keep = keep.view(keep.shape + (1,) * (pool.dim() - 2))
    pool[dst] = torch.where(keep, rows, torch.full(
        (), fill, dtype=pool.dtype, device=pool.device))
    return pool


def cow_page_copy(pools: Sequence[torch.Tensor], sdr: torch.Tensor, *,
                  fills: Sequence[int]) -> List[torch.Tensor]:
    """Apply the ``[src, dst, rem]`` jobs ``sdr`` (NJ, 3) int32 to every
    pool leaf (N, ps, ...), in place. Jobs name distinct dst pages, none of
    them another job's src. CPU tensors take :func:`cow_page_copy_plain`
    leaf by leaf; CUDA tensors launch the kernel once for all leaves.
    Counts launches in ``cow_page_copy.launches``."""
    name = 'cow_page_copy'
    require(len(pools) == len(fills) and pools, name,
            'one fill per pool leaf')
    if on_cpu(name, sdr, *pools):
        for pool, f in zip(pools, fills):
            cow_page_copy_plain(pool, sdr, fill=f)
        return list(pools)
    require(len(pools) <= MAX_LEAVES, name, f'at most {MAX_LEAVES} leaves')
    require(sdr.dim() == 2 and sdr.shape[1] == 3
            and sdr.dtype == torch.int32 and sdr.is_contiguous(), name,
            'sdr must be contiguous (NJ, 3) int32')
    ps = pools[0].shape[1]
    for pool in pools:
        require(pool.dim() >= 2 and pool.shape[1] == ps
                and pool.is_contiguous(), name,
                f'pool leaves must be contiguous (N, {ps}, ...)')
        _element_ok(name, pool)
    NJ = sdr.shape[0]
    if NJ == 0:
        return list(pools)
    n = len(pools)
    lib = build.load(name)
    build.check(lib.cow_page_copy(
        (ctypes.c_void_p * n)(*[p.data_ptr() for p in pools]),
        (ctypes.c_longlong * n)(*[p.shape[0] for p in pools]),
        (ctypes.c_int * n)(*[p[0, 0].numel() * p.element_size()
                             for p in pools]),
        (ctypes.c_uint * n)(*[_fill_bits(p, f)
                              for p, f in zip(pools, fills)]),
        n, sdr.data_ptr(), NJ, ps, build.stream_of(sdr)), name)
    cow_page_copy.launches += 1
    return list(pools)


cow_page_copy.launches = 0


def cow_copy_cache(cache: Dict[str, torch.Tensor], src: int, dst: int,
                   rem: int, *, reps: int = 0, plain: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """Copy-on-write on every leaf of one paged cache, in one launch.
    ``reps > 0``: the leaves are stacked over ``reps`` layers,
    (reps, NP, ps, ...); their leading axes are flattened and one job is
    issued per layer, so the launch count does not grow with depth.
    ``plain`` applies :func:`cow_page_copy_plain` leaf by leaf instead (the
    reference backend's write path)."""
    names = list(cache)
    leaf = cache[names[0]]
    if reps:
        NP = leaf.shape[1]
        rows = [[src + r * NP, dst + r * NP, rem] for r in range(reps)]
        pools = [cache[nm].view((reps * NP,) + tuple(cache[nm].shape[2:]))
                 for nm in names]
    else:
        rows = [[src, dst, rem]]
        pools = [cache[nm] for nm in names]
    sdr = torch.tensor(rows, dtype=torch.int32).to(leaf.device)
    fills = [leaf_fill(nm) for nm in names]
    if plain:
        for pool, f in zip(pools, fills):
            cow_page_copy_plain(pool, sdr, fill=f)
    else:
        cow_page_copy(pools, sdr, fills=fills)
    return cache
