"""The split design of the dense bf16 ``paged_attention``, of its MLA form
over bf16 latent pages and of its int8 form with bf16 queries, and the bf16
tiles of ``flash_attention``.

On the CPU: :func:`paged_attention_chunked_plain`, the split kernel's
arithmetic in fp32 (chunks of a fixed number of keys, a partial softmax per
chunk, the partials combined in chunk order), is held against
``paged_attention_plain`` and JAX's ``ref.paged_attention_ref`` within
``KERNEL_TOL`` (JAX's ``PALLAS_TOL``) at chunk lengths 1, 4 and 128: a
windowed ring that wrapped, page size 1, chunks without a usable key, and
rows without any. Its MLA form (``mla_split``) is held against
``paged_attention_plain`` and JAX's ``paged_attention(mla_split=...)`` in
interpret mode at T 1 and 16, page sizes 1, 8 and 16, chunks of 4 and 64.
Its int8 form (with the scale pages) is held against ``paged_attention_plain``
and JAX's ``ref.paged_attention_ref`` with scales within ``KERNEL_TOL`` at
chunks of 64: T 1 and 16, G 4 and 16, window 0 and 40, page sizes 1 and 16,
slots whose keys end inside a chunk, an empty slot and rows without a usable
key (zeros).

Tests marked ``cuda`` run on a card and skip without one: the split kernel
against the plain version in bf16 at d 16-128, G 4 and 16, T 1, 5, 16;
row independence (row t of a 16-token launch is bitwise a one-token launch
at ``pos0 + t``); ``flash_attention``'s 128-row bf16 tiles across a ragged
S and at G 64; the MLA split kernel against the plain version (fp32 q
over bf16 pages at deepseek-v2-lite-16b's widths and two narrower ones,
page sizes 1, 8, 16) and its row independence; the int8 split kernel (bf16
q over int8 pages at mistral-7b's and glm4-9b's KV, G and d) against the
chunked plain version and its row independence; both split kernels at G 1
(pythia-6.9b's MHA), T 1 and 16. They import nothing of JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_split.py
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (
    mla_split_form, paged_attention, paged_attention_chunked_plain,
    paged_attention_mla, paged_attention_plain, paged_attention_quant,
    quant_split_form, split_form)
from repro_torch.models.attn_backend import KERNEL_TOL

from test_torch_kernels import _assert_flash_close, _flash_inputs, _paged_case

SPLIT_TOL = 2e-2        # bf16, as chip_smoke.py's paged_attention checks


@pytest.fixture(scope='module')
def jref():
    """JAX's oracle; JAX is absent where only the port is installed."""
    jnp = pytest.importorskip('jax.numpy')
    from repro.kernels import ref
    return jnp, ref


@pytest.fixture(scope='module')
def jpa():
    """JAX's Pallas ``paged_attention`` (interpret mode on the CPU)."""
    jnp = pytest.importorskip('jax.numpy')
    from repro.kernels import paged_attention as PA
    return jnp, PA


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run with -m cuda on the card)')
    return torch.device('cuda')


# ------------------------------------------------ the split, on the CPU
def _case(name):
    """(arrays, kwargs, rows that see no key as (b, t) pairs)."""
    if name == 'wrapped_window':          # ring wrapped (slot 0), window 5
        args = _paged_case(0, 3, 5, 2, 2, 16, 24, 8, [31, 11, 0],
                           null_tail=True)
        return args, dict(window=5), [(2, t) for t in range(5)]
    if name == 'page_size_1':             # odd ring: one key a page
        args = _paged_case(1, 2, 3, 1, 4, 16, 13, 1, [20, 6], null_tail=True)
        return args, dict(window=7), []
    if name == 'empty_chunks':            # keys only in the ring's tail
        q, k, v, cpos, table, pos0 = _paged_case(2, 2, 4, 2, 2, 16, 48, 4,
                                                 [48, 30])
        cpos[table[0, :10]] = -1          # slot 0: ring indices 0-39 empty
        return (q, k, v, cpos, table, pos0), dict(window=0), []
    # rows without a usable key: slot 1's stored positions all lie after
    # its first queries
    q, k, v, cpos, table, pos0 = _paged_case(3, 2, 6, 2, 2, 16, 32, 8,
                                             [32, 20])
    pos0[1] = 2
    cpos[table[1]] = np.where(cpos[table[1]] >= 0, cpos[table[1]] + 5, -1)
    return (q, k, v, cpos, table, pos0), dict(window=0), \
        [(1, 0), (1, 1), (1, 2)]


@pytest.mark.parametrize('case', ['wrapped_window', 'page_size_1',
                                  'empty_chunks', 'no_key_rows'])
@pytest.mark.parametrize('chunk', [1, 4, 128])
def test_chunked_plain_matches_plain_and_jax(jref, case, chunk):
    jnp, ref = jref
    arrs, kw, empty = _case(case)
    d = arrs[0].shape[-1]
    kw = dict(kw, scale=d ** -0.5)
    targs = [torch.from_numpy(a) for a in arrs]
    got = paged_attention_chunked_plain(*targs, **kw, chunk=chunk).numpy()
    plain = paged_attention_plain(*targs, **kw).numpy()
    want = np.asarray(ref.paged_attention_ref(*map(jnp.asarray, arrs), **kw))
    np.testing.assert_allclose(got, plain, **KERNEL_TOL)
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    for b, t in empty:
        assert not got[b, t].any(), (b, t)


def test_chunked_plain_bf16_matches_plain():
    """In bf16 (the split kernel's dtype) the split changes nothing but fp32
    rounding, which the cast to bf16 mostly hides."""
    arrs, kw, _ = _case('wrapped_window')
    targs = [torch.from_numpy(a) for a in arrs]
    targs = [a.bfloat16() if a.is_floating_point() else a for a in targs]
    kw = dict(kw, scale=16 ** -0.5)
    got = paged_attention_chunked_plain(*targs, **kw, chunk=4)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               paged_attention_plain(*targs, **kw).float(),
                               atol=SPLIT_TOL, rtol=SPLIT_TOL)


def test_split_form_by_dtype_and_width():
    """The split kernel takes bf16 q over bf16 pages at d % 16 == 0, d <=
    128, and at d 256 (gemma3-1b); fp32 pages, mixed dtypes and other
    widths keep the template."""
    def t(d, dtype=torch.bfloat16):
        return torch.zeros((1, 1, 1, 1, d), dtype=dtype)
    for d in (16, 32, 48, 64, 128, 256):
        assert split_form(t(d), t(d), t(d))
    for d in (8, 24, 136, 192, 512):
        assert not split_form(t(d), t(d), t(d))
    f = torch.float32
    assert not split_form(t(128, f), t(128, f), t(128, f))
    assert not split_form(t(128, f), t(128), t(128))
    assert not split_form(t(128), t(128, f), t(128, f))


def _slot_pages(rng, B, T, ps, lengths):
    """(NP, table, stored positions, pos0) of slots through a scattered
    table: slot b holds positions [0, lengths[b]), unallocated blocks map
    to the null page 0, queries for the last T positions. The last slot's
    positions are moved up by 8 and its queries start at position 0, so
    its rows t < 8 have no usable key."""
    P = -(-max(max(lengths), 1) // ps) + 1
    NP = 1 + B * P
    table = (rng.permutation(NP - 1)[:B * P] + 1).reshape(B, P) \
        .astype(np.int32)
    cpos = np.full((NP, ps), -1, np.int32)
    for b, n in enumerate(lengths):
        table[b, -(-n // ps):] = 0
        for p in range(n):
            cpos[table[b, p // ps], p % ps] = p
    pos0 = np.array([max(n - T, 0) for n in lengths], np.int32)
    late = np.unique(table[-1][table[-1] > 0])
    cpos[late] = np.where(cpos[late] >= 0, cpos[late] + 8, -1)
    pos0[-1] = 0
    return NP, table, cpos, pos0


def _mla_case(seed, B, T, H, r, dr, ps, lengths):
    """MLA latent pages (ckv, kpe as bf16) over ``_slot_pages``; fp32
    queries [q_abs | q_pe]."""
    rng = np.random.default_rng(seed)
    NP, table, cpos, pos0 = _slot_pages(rng, B, T, ps, lengths)
    ckv, kpe = (torch.from_numpy(rng.standard_normal((NP, ps, 1, w))
                                 .astype(np.float32)).bfloat16()
                for w in (r, dr))
    ckv[0], kpe[0] = 0, 0
    q = torch.from_numpy(rng.standard_normal((B, T, 1, H, r + dr))
                         .astype(np.float32))
    return q, ckv, kpe, torch.from_numpy(cpos), torch.from_numpy(table), \
        torch.from_numpy(pos0)


def _assert_late_rows(got, T):
    """The last slot of ``_mla_case``: zeros where no key is usable."""
    assert not got[-1, :min(T, 8)].any()
    assert T <= 8 or got[-1, 8:].abs().sum(-1).gt(0).all()


@pytest.mark.parametrize('T', [1, 16])
def test_mla_chunked_plain_matches_plain_and_jax(jpa, T):
    """The MLA split's arithmetic at page sizes 1, 8 and 16 and chunks of 4
    and 64 keys: two slots mid-page, an empty slot (zeros) and a slot whose
    first rows have no usable key (zeros), fp32 queries over bf16 latent
    pages. (One case per T, the page sizes and
    chunks inside: ROADMAP C4 keeps the suite under 888 collected tests.)"""
    jnp, PA = jpa
    B, H, r, dr = 4, 4, 32, 16
    kw = dict(scale=(16 + dr) ** -0.5, window=0)

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype)
    for ps in (1, 8, 16):
        q, ckv, kpe, cpos, table, pos0 = _mla_case(T + ps, B, T, H, r, dr,
                                                   ps, [45, 20, 0, 20])
        want = np.asarray(PA.paged_attention(
            j(q), j(ckv), None, j(cpos), j(table), j(pos0), k2_pages=j(kpe),
            mla_split=r, interpret=True, **kw))
        args = (q, ckv, None, cpos, table, pos0)
        plain = paged_attention_plain(*args, k2_pages=kpe, mla_split=r, **kw)
        for chunk in (4, 64):
            got = paged_attention_chunked_plain(*args, k2_pages=kpe,
                                                mla_split=r, chunk=chunk,
                                                **kw)
            assert got.dtype == torch.float32 \
                and got.shape == (B, T, 1, H, r)
            np.testing.assert_allclose(got.numpy(), plain.numpy(),
                                       **KERNEL_TOL)
            np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
            assert not got[2].any(), (ps, chunk)
            _assert_late_rows(got, T)


def test_mla_split_form_by_dtype_and_width():
    """fp32 q over bf16 latent pages at r, dr % 16 == 0 and <= 512 take the
    split kernel; fp32 pages (the smoke configs'), bf16 q and other widths
    keep the template."""
    def t(w, dtype=torch.bfloat16):
        return torch.zeros((1, 1, 1, 1, w), dtype=dtype)
    f = torch.float32
    for r, dr in ((512, 64), (32, 16), (48, 16), (512, 512)):
        assert mla_split_form(t(r + dr, f), t(r), t(dr))
    for r, dr in ((512, 8), (520, 64), (24, 16), (528, 64)):
        assert not mla_split_form(t(r + dr, f), t(r), t(dr))
    assert not mla_split_form(t(576, f), t(512, f), t(64, f))
    assert not mla_split_form(t(576), t(512), t(64))


def _quant_case(seed, T, KV, G, d, ps, lengths):
    """int8 K/V pages with bf16 scales over ``_slot_pages`` (values as the
    quantizer writes them: int8 in [-127, 127], scales amax / 127 of
    activations of magnitude ~1-10), fp32 queries: q, k, v, k_scale,
    v_scale, cpos, table, pos0."""
    rng = np.random.default_rng(seed)
    NP, table, cpos, pos0 = _slot_pages(rng, len(lengths), T, ps, lengths)
    k, v = (torch.from_numpy(rng.integers(-127, 128, (NP, ps, KV, d))
                             .astype(np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.085, (NP, ps, KV))
                               .astype(np.float32)).bfloat16()
              for _ in range(2))
    k[0], v[0] = 0, 0
    q = torch.from_numpy(rng.standard_normal((len(lengths), T, KV, G, d))
                         .astype(np.float32))
    return q, k, v, ks, vs, torch.from_numpy(cpos), torch.from_numpy(table), \
        torch.from_numpy(pos0)


# (G, window, page size) of the int8 cases: glm4-9b's G 16 and mistral-7b's
# G 4, causal and windowed, one key a page and 16
QUANT_CASES = [(4, 0, 16), (16, 0, 1), (4, 40, 1), (16, 40, 16)]
QUANT_LENGTHS = [150, 101, 0, 20]      # keys end inside chunks 2 and 1


def _quant_limit(want, dtype):
    """KERNEL_TOL, and for bf16 queries one bf16 step of the output on top
    (2^-7 of its magnitude: two fp32 sums that differ in their last bits
    may round to neighbouring bf16 values), as chip_smoke.py's int8
    checks."""
    w = want.float().abs()
    lim = KERNEL_TOL['atol'] + KERNEL_TOL['rtol'] * w
    return lim + w * 2.0 ** -7 if dtype == torch.bfloat16 else lim


@pytest.mark.parametrize('T', [1, 16])
def test_quant_chunked_plain_matches_plain_and_jax(jref, T):
    """The int8 split's arithmetic, chunks of 64 keys: ``(q·k)·k_scale``
    before ``scale``, ``l`` over ``p``, the value mix over ``p·v_scale``.
    fp32 queries against the plain version and JAX's oracle with scales
    within KERNEL_TOL; bf16 queries (the split kernel's) against the plain
    version in bf16 within KERNEL_TOL and one bf16 step. (One case per T:
    ROADMAP C4 keeps the suite under 888 collected tests.)"""
    jnp, ref = jref
    d = 32
    for G, window, ps in QUANT_CASES:
        q, k, v, ks, vs, cpos, table, pos0 = _quant_case(
            T + G + ps + window, T, 2, G, d, ps, QUANT_LENGTHS)
        kw = dict(scale=d ** -0.5, window=window)
        sc = dict(k_scale_pages=ks, v_scale_pages=vs)
        got = paged_attention_chunked_plain(q, k, v, cpos, table, pos0,
                                            chunk=64, **sc, **kw)
        plain = paged_attention_plain(q, k, v, cpos, table, pos0, **sc, **kw)
        want = np.asarray(ref.paged_attention_ref(
            *(jnp.asarray(t.numpy()) for t in (q, k, v, cpos, table, pos0)),
            k_scale_pages=jnp.asarray(ks.float().numpy()).astype(
                jnp.bfloat16),
            v_scale_pages=jnp.asarray(vs.float().numpy()).astype(
                jnp.bfloat16), **kw))
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **KERNEL_TOL)
        np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
        assert not got[2].any(), (G, window, ps)
        _assert_late_rows(got, T)
        qb = q.bfloat16()
        gb = paged_attention_chunked_plain(qb, k, v, cpos, table, pos0,
                                           chunk=64, **sc, **kw)
        pb = paged_attention_plain(qb, k, v, cpos, table, pos0, **sc, **kw)
        assert gb.dtype == torch.bfloat16
        assert bool(((gb.float() - pb.float()).abs()
                     <= _quant_limit(pb, torch.bfloat16)).all())


def test_quant_split_form_by_dtype_and_width():
    """bf16 q over int8 pages at d % 16 == 0, d <= 128, and at d 256 take
    the split kernel; fp32 q (the smoke configs') and other widths keep
    the template."""
    def t(d, dtype=torch.bfloat16):
        return torch.zeros((1, 1, 1, 1, d), dtype=dtype)
    i8 = torch.int8
    for d in (16, 32, 48, 64, 128, 256):
        assert quant_split_form(t(d), t(d, i8))
    for d in (8, 24, 136, 192, 512):
        assert not quant_split_form(t(d), t(d, i8))
    assert not quant_split_form(t(128, torch.float32), t(128, i8))
    assert not quant_split_form(t(128), t(128))


# ------------------------------------------------------ on the card
def _scattered(cuda, seed, B, T, KV, G, d, Sc, ps, lengths):
    """A paged case (``_paged_case``) with its pages permuted, so the table
    scatters; bf16 on the card."""
    q, k, v, cpos, table, pos0 = _paged_case(seed, B, T, KV, G, d, Sc, ps,
                                             lengths)
    perm = np.random.default_rng(seed).permutation(k.shape[0] - 1) + 1
    inv = np.empty_like(perm)
    inv[perm - 1] = np.arange(1, k.shape[0])
    k[1:], v[1:], cpos[1:] = k[perm], v[perm], cpos[perm]
    table = np.where(table > 0, inv[np.maximum(table, 1) - 1], 0) \
        .astype(np.int32)
    out = [torch.from_numpy(a).to(cuda) for a in (q, k, v, cpos, table,
                                                   pos0)]
    return [a.bfloat16() if a.is_floating_point() else a for a in out]


def _row_share(got, want):
    """The largest share of chip_smoke.py's row-scaled limit, |err| <= 0.02
    rms(row) + 0.016 |want|, that any element uses."""
    w = want.float()
    limit = 0.02 * w.pow(2).mean(-1, keepdim=True).sqrt() + 0.016 * w.abs()
    return ((got.float() - w).abs() / limit.clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize('T', [1, 5, 16])
@pytest.mark.parametrize('G', [4, 16])
@pytest.mark.parametrize('d', [16, 32, 64, 128])
def test_paged_split_kernel_matches_plain(cuda, d, G, T):
    """The split kernel in bf16 against the plain version: a ring that
    wrapped, a slot of 150 keys, an empty slot; 320-key rings over three
    chunks, a scattered table of 16-token pages; window 100 at T 5."""
    window = 100 if T == 5 else 0
    args = _scattered(cuda, d + G + T, 3, T, 2, G, d, 320, 16,
                      [361, 150, 0])
    kw = dict(scale=d ** -0.5, window=window)
    n0 = paged_attention.launches
    got = paged_attention(*args, **kw)
    want = paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and not got[2].any()
    torch.testing.assert_close(got.float(), want.float(), atol=SPLIT_TOL,
                               rtol=SPLIT_TOL)
    assert _row_share(got, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize('G,window,ps', [(16, 0, 16), (4, 300, 1),
                                         (4, 0, 128)])
def test_paged_split_row_independence(cuda, G, window, ps):
    """Row t of a 16-token launch is bitwise a one-token launch at pos0 + t:
    a row's arithmetic depends on its query, its keys and the fixed chunk
    layout, not on T or the other rows of its tile (glm4-9b's G 16 over
    scattered pages; mistral-7b's G 4 over a windowed ring of page size 1;
    one page of 128)."""
    d, T = 128, 16
    args = _scattered(cuda, 7 + G + ps, 4, T, 2, G, d, 384, ps,
                      [300, 271, 0, 529])
    q, k, v, cpos, table, pos0 = args
    kw = dict(scale=d ** -0.5, window=window)
    full = paged_attention(*args, **kw)
    for t in range(T):
        one = paged_attention(q[:, t:t + 1].contiguous(), k, v, cpos, table,
                              pos0 + t, **kw)
        assert torch.equal(one, full[:, t:t + 1]), t


MLA_WIDTHS = [(16, 512, 64),     # deepseek-v2-lite-16b: 8 value groups a warp
              (4, 128, 32),      # 2 groups a warp
              (3, 48, 16)]       # 3 groups over 4 warps; tiles across tokens


def _mla_cuda(cuda, seed, T, H, r, dr, ps, lengths):
    return [a.to(cuda) for a in _mla_case(seed, len(lengths), T, H, r, dr,
                                          ps, lengths)]


@pytest.mark.cuda
def test_mla_split_kernel_matches_plain(cuda):
    """The MLA split kernel against the plain version within KERNEL_TOL at
    every width of MLA_WIDTHS, T 1 and 16, page sizes 1, 8 and 16: slots
    of 300 / 271 / 0 / 365 / 120 tokens through a scattered table, one
    launch counted a call, the empty slot zeros, and zeros for the last
    slot's rows that have no usable key."""
    for (H, r, dr), T, ps in itertools.product(MLA_WIDTHS, (1, 16),
                                               (1, 8, 16)):
        q, ckv, kpe, cpos, table, pos0 = _mla_cuda(
            cuda, r + T + ps, T, H, r, dr, ps, [300, 271, 0, 365, 120])
        assert mla_split_form(q, ckv, kpe)
        kw = dict(scale=(128 + dr) ** -0.5, k2_pages=kpe, mla_split=r)
        n0 = paged_attention_mla.launches
        got = paged_attention(q, ckv, None, cpos, table, pos0, **kw)
        want = paged_attention_plain(q, ckv, None, cpos, table, pos0, **kw)
        torch.cuda.synchronize()
        assert paged_attention_mla.launches == n0 + 1
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        assert not got[2].any(), (r, T, ps)
        _assert_late_rows(got, T)


@pytest.mark.cuda
def test_mla_split_row_independence(cuda):
    """Row t of a 16-token MLA launch is bitwise a one-token launch at
    pos0 + t (the fixed chunk layout), at every width of MLA_WIDTHS and
    page sizes 16 and 1."""
    T = 16
    for (H, r, dr), ps in itertools.product(MLA_WIDTHS, (16, 1)):
        q, ckv, kpe, cpos, table, pos0 = _mla_cuda(
            cuda, 5 + ps, T, H, r, dr, ps, [300, 271, 0, 365, 120])
        kw = dict(scale=(128 + dr) ** -0.5, k2_pages=kpe, mla_split=r)
        full = paged_attention(q, ckv, None, cpos, table, pos0, **kw)
        for t in range(T):
            one = paged_attention(q[:, t:t + 1].contiguous(), ckv, None,
                                  cpos, table, pos0 + t, **kw)
            assert torch.equal(one, full[:, t:t + 1]), (r, ps, t)


FLASH_TILE_SHAPES = [(1, 300, 64, 1, 128, 0),     # G 64: 2 positions a tile
                     (2, 1000, 16, 1, 128, 0),    # G 16, ragged S
                     (1, 517, 32, 8, 128, 100),   # G 4 (32 positions), window
                     (1, 129, 6, 2, 64, 0),       # G 3: 126 rows of 128
                     (1, 4097, 32, 2, 128, 0)]    # glm4-9b's ragged S


@pytest.mark.cuda
@pytest.mark.parametrize('B,S,H,KH,d,window', FLASH_TILE_SHAPES)
def test_flash_bf16_tiles(cuda, B, S, H, KH, d, window):
    """flash_attention's bf16 kernel (128 query rows a block, K/V tiles in
    flight) against its plain version: groups that fill 128 rows with 2 to
    32 positions, one that leaves rows empty, ragged S."""
    q, k, v = [torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _flash_inputs(B, S, H, KH, d)]
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None] \
        .expand(B, S).contiguous()
    got = flash_attention(q, k, v, pos, window=window)
    _assert_flash_close(got, flash_attention_plain(q, k, v, pos,
                                                   window=window))


# (KV, G, window, page size, slot lengths) at the int8 engines' widths (d
# 128): glm4-9b's KV 2, G 16 through 16-token pages; mistral-7b's KV 8, G 4
# with its 4096 window and a 300 one, over pages of one key (an odd ring's
# dense view)
QUANT_SHAPES = [(2, 16, 0, 16, [300, 271, 0, 365]),
                (8, 4, 4096, 1, [512, 300, 0, 200]),
                (8, 4, 300, 16, [512, 450, 0, 365])]


def _quant_cuda(cuda, seed, T, KV, G, ps, lengths):
    out = [a.to(cuda) for a in _quant_case(seed, T, KV, G, 128, ps,
                                           lengths)]
    out[0] = out[0].bfloat16()
    return out


@pytest.mark.cuda
def test_quant_split_kernel_matches_plain(cuda):
    """The int8 split kernel against the chunked plain version (chunks of
    64) at each of QUANT_SHAPES, T 1 and 16: within KERNEL_TOL and one bf16
    step, and within chip_smoke.py's row-scaled limit; one launch counted a
    call (the dense form's count unchanged); the empty slot and the last
    slot's rows without a usable key zeros."""
    for (KV, G, window, ps, lengths), T in itertools.product(QUANT_SHAPES,
                                                             (1, 16)):
        args = _quant_cuda(cuda, KV + G + ps + T, T, KV, G, ps, lengths)
        q, k = args[:2]
        assert quant_split_form(q, k)
        kw = dict(scale=128 ** -0.5, window=window)
        n0 = (paged_attention.launches, paged_attention_quant.launches)
        got = paged_attention_quant(*args, **kw)
        want = paged_attention_chunked_plain(
            q, k, args[2], *args[5:], chunk=64, k_scale_pages=args[3],
            v_scale_pages=args[4], **kw)
        torch.cuda.synchronize()
        assert (paged_attention.launches, paged_attention_quant.launches) \
            == (n0[0], n0[1] + 1)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert bool(((got.float() - want.float()).abs()
                     <= _quant_limit(want, torch.bfloat16)).all()), \
            (KV, G, window, ps, T)
        assert _row_share(got, want) <= 1, (KV, G, window, ps, T)
        assert not got[2].any()
        _assert_late_rows(got, T)


@pytest.mark.cuda
def test_split_kernels_at_group_1(cuda):
    """MHA (pythia-6.9b: 32 kv heads, G 1, d 128), one query row a (slot,
    kv head) at T 1: the dense split kernel (bf16 q and pages) within
    SPLIT_TOL and the row-scaled limit of its plain version, and the int8
    split kernel (bf16 q over int8 pages) within KERNEL_TOL and one bf16
    step and the row-scaled limit of the chunked plain version, at T 1 and
    16 over scattered 16-token pages; for T 16, row t bitwise a one-token
    call at pos0 + t."""
    KV, d, ps = 32, 128, 16
    lengths = [300, 271, 0, 365]
    for form, T in itertools.product(('dense', 'int8'), (1, 16)):
        if form == 'dense':
            args = _scattered(cuda, 11 + T, len(lengths), T, KV, 1, d, 384,
                              ps, lengths)
            fn = paged_attention
            assert split_form(*args[:3])
        else:
            args = _quant_cuda(cuda, 13 + T, T, KV, 1, ps, lengths)
            fn = paged_attention_quant
            assert quant_split_form(*args[:2])
        q, pos0 = args[0], args[-1]
        kw = dict(scale=d ** -0.5, window=0)
        got = fn(*args, **kw)
        if form == 'dense':
            want = paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=SPLIT_TOL, rtol=SPLIT_TOL)
        else:
            want = paged_attention_chunked_plain(
                q, args[1], args[2], *args[5:], chunk=64,
                k_scale_pages=args[3], v_scale_pages=args[4], **kw)
            torch.cuda.synchronize()
            assert bool(((got.float() - want.float()).abs()
                         <= _quant_limit(want, torch.bfloat16)).all()), T
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert _row_share(got, want) <= 1, (form, T)
        assert not got[2].any()
        for t in range(T if T > 1 else 0):
            one = fn(q[:, t:t + 1].contiguous(), *args[1:-1], pos0 + t, **kw)
            assert torch.equal(one, got[:, t:t + 1]), (form, t)


@pytest.mark.cuda
def test_quant_split_row_independence(cuda):
    """Row t of a 16-token int8 launch is bitwise a one-token launch at
    pos0 + t (the fixed chunk layout), at each of QUANT_SHAPES."""
    T = 16
    for KV, G, window, ps, lengths in QUANT_SHAPES:
        args = _quant_cuda(cuda, 3 + KV + ps, T, KV, G, ps, lengths)
        q, pos0 = args[0], args[-1]
        kw = dict(scale=128 ** -0.5, window=window)
        full = paged_attention_quant(*args, **kw)
        for t in range(T):
            one = paged_attention_quant(q[:, t:t + 1].contiguous(),
                                        *args[1:-1], pos0 + t, **kw)
            assert torch.equal(one, full[:, t:t + 1]), (KV, G, ps, t)
