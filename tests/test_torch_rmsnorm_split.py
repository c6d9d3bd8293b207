"""The two bf16 designs of ``rmsnorm_matmul`` and the row split of
``embed_gather``.

On the CPU: the arithmetic of the split-K and wgmma forms, as plain mirrors,
against ``rmsnorm_qkv_plain`` and JAX's ``ref.rmsnorm_qkv_ref`` /
``ops.rmsnorm_qkv`` (the Pallas kernel in interpret mode):

- :func:`rmsnorm_qkv_splitk_plain` (the split-K form: fp32 rows, d cut into
  slices whose fp32 partials are summed in slice order) at 1, 3 and d / 16
  slices and at the kernel's own count, in fp32 within atol 2e-4 / rtol 2e-3
  (the cross-framework bound of the port's fp32 tests);
- :func:`rmsnorm_qkv_hilo_plain` (the wgmma form: the rows split into bf16
  hi and lo, ``hi @ W + lo @ W`` in fp32) in bf16 within 3e-2
  (``tests/test_kernels.py``'s bf16 tolerance).

Tests marked ``cuda`` run on a card and skip without one: both forms at
mistral-7b and glm4-9b width on both sides of the crossover (N 1-8192),
forced and as the shape chooses, within 3e-2 and chip_smoke.py's row-scaled
limit; the shapes those forms do not take keep the tiled kernel; and
``embed_gather`` at width 10240, N 1 and 4096, with ids out of range. They
import nothing of JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_rmsnorm_split.py
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import rmsnorm_qkv as R
from repro_torch.kernels.embed_gather import embed_gather, embed_gather_plain

F32_TOL = dict(atol=2e-4, rtol=2e-3)
BF16_TOL = 3e-2
# chip_smoke.py's RMS_ROW_TOL: one bf16 step of the output and 1e-3 of the
# row's RMS
ROW_TOL = dict(row=1e-3, rtol=2 ** -7)
SHAPES = [(64, 64, 64, 32), (33, 96, 96, 24), (130, 128, 200, 72)]


@pytest.fixture(scope='module')
def jref():
    """JAX's kernels and oracle; JAX is absent where only the port is
    installed."""
    jnp = pytest.importorskip('jax.numpy')
    from repro.kernels import ops, ref
    return jnp, ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run with -m cuda on the card)')
    return torch.device('cuda')


def _inputs(N, d, q, e, seed=0):
    """x, scale, wq, wk, wv as float32 numpy, weights scaled by 1/sqrt(d)."""
    rng = np.random.default_rng(seed + N + d + q + e)
    x = rng.standard_normal((N, d)).astype(np.float32)
    scale = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    return (x, scale) + tuple(
        (rng.standard_normal((d, w)) / np.sqrt(d)).astype(np.float32)
        for w in (q, e, e))


def _kernel_splits(d):
    """The split-K form's slice count (csrc/rmsnorm_matmul.cu,
    ``splitk_splits``): slices of at most 128."""
    return -(-d // 128)


# ------------------------------------------------------- on the CPU
@pytest.mark.parametrize('splits', ['1', '3', 'd/16', 'kernel'])
@pytest.mark.parametrize('N,d,q,e', SHAPES)
def test_splitk_plain_matches_jax(jref, N, d, q, e, splits):
    jnp, ops, ref = jref
    arrs = _inputs(N, d, q, e)
    n = {'1': 1, '3': 3, 'd/16': d // 16, 'kernel': _kernel_splits(d)}[splits]
    targs = [torch.from_numpy(a) for a in arrs]
    got = R.rmsnorm_qkv_splitk_plain(*targs, splits=n)
    plain = R.rmsnorm_qkv_plain(*targs)
    jargs = [jnp.asarray(a) for a in arrs]
    for want in (ops.rmsnorm_qkv(*jargs), ref.rmsnorm_qkv_ref(*jargs)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
    for g, p in zip(got, plain):
        assert g.dtype == torch.float32 and g.shape == p.shape
        torch.testing.assert_close(g, p, **F32_TOL)


def test_splitk_plain_empty_slices():
    """More slices than d allows full ones: the last slices are short or
    empty and add nothing."""
    targs = [torch.from_numpy(a) for a in _inputs(5, 96, 40, 16)]
    many = R.rmsnorm_qkv_splitk_plain(*targs, splits=40)   # 32 of 3, 8 empty
    for g, p in zip(many, R.rmsnorm_qkv_plain(*targs)):
        torch.testing.assert_close(g, p, **F32_TOL)


@pytest.mark.parametrize('N,d,q,e', SHAPES)
def test_hilo_plain_matches_jax(jref, N, d, q, e):
    jnp, ops, ref = jref
    arrs = _inputs(N, d, q, e)
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    got = R.rmsnorm_qkv_hilo_plain(*targs)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    for want in (ops.rmsnorm_qkv(*jargs), ref.rmsnorm_qkv_ref(*jargs)):
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w.astype(jnp.float32)),
                                       atol=BF16_TOL, rtol=BF16_TOL)
    for g, p in zip(got, R.rmsnorm_qkv_plain(*targs)):
        torch.testing.assert_close(g.float(), p.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL)


def test_hilo_plain_keeps_16_bits():
    """In fp32, hi + lo holds the normalised row to ~2^-18 of its size: the
    hi/lo product is within 3e-5 of the fp32 plain version, 30x closer
    than one bf16 product of the rows (hi alone)."""
    x, scale, wq, wk, wv = map(torch.from_numpy, _inputs(16, 256, 64, 32))
    got = R.rmsnorm_qkv_hilo_plain(x, scale, wq, wk, wv)
    plain = R.rmsnorm_qkv_plain(x, scale, wq, wk, wv)
    hi = R._normed(x, scale, R.EPS).to(torch.bfloat16).float()
    for g, p, w in zip(got, plain, (wq, wk, wv)):
        e_hilo = (g - p).abs().max().item()
        e_hi = (hi @ w - p).abs().max().item()
        assert e_hilo < 3e-5 and e_hi > 30 * e_hilo, (e_hilo, e_hi)


def test_forms_match_source():
    """``FORMS`` numbers the forms as the C source does."""
    src = (build.CSRC / 'rmsnorm_matmul.cu').read_text()
    m = re.search(r'constexpr int kFormTiled = (\d), kFormSplitK = (\d), '
                  r'kFormWgmma = (\d);', src)
    assert m and [int(v) for v in m.groups()] == [
        R.FORMS.index(f) for f in ('tiled', 'splitk', 'wgmma')]
    assert re.search(r'kSkSlice = 128;', src)


# ------------------------------------------------------------ on a card
def _assert_rms_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL)
        w = w.float()
        rms = w.pow(2).mean(-1, keepdim=True).sqrt()
        limit = ROW_TOL['row'] * rms + ROW_TOL['rtol'] * w.abs()
        assert bool(((g.float() - w).abs() <= limit).all())


def _card_inputs(cuda, N, d, q, e, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed + N + e)
    x = torch.randn((N, d), generator=gen, device=cuda)
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=cuda)
    ws = [torch.randn((d, w), generator=gen, device=cuda) / d ** 0.5
          for w in (q, e, e)]
    return [t.to(torch.bfloat16) for t in (x, scale, *ws)]


@pytest.mark.cuda
@pytest.mark.parametrize('e', [1024, 256], ids=['mistral', 'glm4'])
@pytest.mark.parametrize('N', [1, 4, 8, 33, 64, 128, 4097, 8192])
def test_forms_full_width(cuda, N, e):
    """At full width the shape picks split-K up to N 8 and wgmma above;
    one call counts one launch."""
    args = _card_inputs(cuda, N, 4096, 4096, e)
    assert R.rmsnorm_matmul_form(args[0], args[2:]) == \
        ('splitk' if N <= 8 else 'wgmma')
    n0 = R.rmsnorm_matmul.launches
    got = R.rmsnorm_qkv(*args)
    torch.cuda.synchronize()
    assert R.rmsnorm_matmul.launches == n0 + 1
    _assert_rms_close(got, R.rmsnorm_qkv_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['splitk', 'wgmma'])
@pytest.mark.parametrize('N', [1, 4, 8, 9, 16, 33, 64])
def test_both_forms_across_the_crossover(cuda, N, form):
    """Either form forced at decode sizes, mistral-7b width."""
    x, scale, *ws = _card_inputs(cuda, N, 4096, 4096, 1024)
    got = R._launch(x, scale, ws, R.EPS, form)
    torch.cuda.synchronize()
    _assert_rms_close(got, R.rmsnorm_qkv_plain(x, scale, *ws))


@pytest.mark.cuda
def test_other_shapes_keep_the_tiled_kernel(cuda):
    """Widths that are not multiples of 8, weights that are not 16-byte
    aligned and fp32 take the tiled kernel; the other forms refuse them."""
    x, scale, *ws = _card_inputs(cuda, 1, 40, 20, 12)
    assert R.rmsnorm_matmul_form(x, ws) == 'tiled'
    with pytest.raises(ValueError):
        R._launch(x, scale, ws, R.EPS, 'wgmma')
    x, scale, *ws = _card_inputs(cuda, 70, 64, 64, 32)
    buf = torch.empty(64 * 33, dtype=torch.bfloat16, device=cuda)
    odd = buf[1:1 + 64 * 32].view(64, 32)        # base 2 bytes off
    odd.copy_(ws[1])
    assert R.rmsnorm_matmul_form(x, [ws[0], odd, ws[2]]) == 'tiled'
    got = R.rmsnorm_qkv(x, scale, ws[0], odd, ws[2])
    torch.cuda.synchronize()
    for g, w in zip(got, R.rmsnorm_qkv_plain(x, scale, *ws)):
        torch.testing.assert_close(g.float(), w.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL)
    f32 = [t.float() for t in (x, scale, *ws)]
    assert R.rmsnorm_matmul_form(f32[0], f32[2:]) == 'tiled'


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('N', [1, 4096])
def test_embed_gather_row_split(cuda, N, dtype):
    """Rows of 10240 split over blocks: bitwise ``table[ids]``; for ids
    outside [0, V) the plain version (``jnp.take``: id -1 reads row V - 1,
    bitwise; id V gives a row of NaN)."""
    V, W = 1000, 10240
    gen = torch.Generator(device=cuda).manual_seed(N)
    table = torch.randn((V, W), generator=gen, device=cuda).to(dtype)
    ids = torch.randint(0, V, (N,), generator=gen, device=cuda,
                        dtype=torch.int32)
    got = embed_gather(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, embed_gather_plain(table, ids))
    ids[::2] = torch.tensor([-1, V], dtype=torch.int32,
                            device=cuda).repeat(N)[:len(ids[::2])]
    got = embed_gather(table, ids)
    want = embed_gather_plain(table, ids)
    torch.cuda.synchronize()
    nan = (ids == V)[:, None].expand(-1, W)
    assert torch.equal(got.isnan(), nan) and torch.equal(want.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])
