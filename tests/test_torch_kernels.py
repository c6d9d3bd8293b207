"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; those are held
against the JAX kernels as the JAX tests run them here (Pallas in interpret
mode): ``embed_gather`` bitwise, ``gather_rope`` within 1e-4 (fp32) / 3e-2
(bf16), ``paged_attention`` within ``PALLAS_TOL`` (atol = rtol = 2e-4).

Tests marked ``cuda`` hold each CUDA kernel against its plain version on a
card and skip without one. They import nothing of JAX, so on a machine with
only the port they run with:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.embed_gather import embed_gather, embed_gather_plain
from repro_torch.kernels.gather_rope import gather_rope, gather_rope_plain
from repro_torch.kernels.paged_attention import (dense_as_pages,
                                                 dense_identity_table,
                                                 dense_page_split,
                                                 paged_attention,
                                                 paged_attention_plain)
from repro_torch.models.attn_backend import KERNEL_TOL


@pytest.fixture(scope='module')
def jx():
    """The JAX reference; JAX is absent where only the port is installed."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from repro.kernels import ops
    from repro.kernels import paged_attention as PA
    return jax, jnp, ops, PA


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run with -m cuda on the card)')
    return torch.device('cuda')


def _table(seed, V, W):
    return np.random.default_rng(seed).standard_normal((V, W)) \
        .astype(np.float32)


def _tdtype(name):
    return {'float32': torch.float32, 'bfloat16': torch.bfloat16}[name]


# ------------------------------------------------------------ embed_gather
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('V,W,N', [(64, 128, 8), (503, 320, 33),
                                   (100, 130, 5)])
def test_embed_gather_matches_jax_bitwise(jx, V, W, N, dtype):
    jax, jnp, ops, _ = jx
    tab = _table(0, V, W)
    ids = np.random.default_rng(1).integers(0, V, N).astype(np.int32)
    want = ops.embed_gather_rows(jnp.asarray(tab).astype(dtype),
                                 jnp.asarray(ids))
    got = embed_gather(torch.from_numpy(tab).to(_tdtype(dtype)),
                       torch.from_numpy(ids))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_cpu_wrappers_take_plain_versions_and_count_no_launch():
    tab = torch.randn(16, 64)
    ids = torch.tensor([3, 0, 15], dtype=torch.int32)
    before = (embed_gather.launches, gather_rope.launches,
              paged_attention.launches)
    assert torch.equal(embed_gather(tab, ids), embed_gather_plain(tab, ids))
    pos = torch.tensor([0, 7, 300], dtype=torch.int32)
    kw = dict(segs=((0, 2, 16),), theta=1e4)
    assert torch.equal(gather_rope(tab, ids, pos, **kw),
                       gather_rope_plain(tab, ids, pos, **kw))
    assert (embed_gather.launches, gather_rope.launches,
            paged_attention.launches) == before


def test_wrappers_reject_mixed_devices():
    tab = torch.randn(16, 64)
    with pytest.raises(ValueError, match='all lie on the CPU'):
        embed_gather(tab, torch.zeros(2, dtype=torch.int32, device='meta'))


# ------------------------------------------------------------- gather_rope
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('V,W,N,H,KH,hd', [(64, 256, 8, 4, 2, 16),
                                           (100, 260, 17, 4, 2, 16),
                                           (503, 384, 33, 2, 1, 32)])
def test_gather_rope_matches_jax(jx, V, W, N, H, KH, hd, dtype):
    jax, jnp, ops, _ = jx
    d = 64                                  # x segment before q
    tab = _table(0, V, W)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, V, N).astype(np.int32)
    pos = rng.integers(0, 512, N).astype(np.int32)
    q_off, k_off = d, d + H * hd
    want = ops.gather_rope_rows(jnp.asarray(tab).astype(dtype),
                                jnp.asarray(ids), jnp.asarray(pos),
                                q_off=q_off, num_heads=H, k_off=k_off,
                                num_kv_heads=KH, head_dim=hd, theta=1e4)
    ttab = torch.from_numpy(tab).to(_tdtype(dtype))
    got = gather_rope(ttab, torch.from_numpy(ids), torch.from_numpy(pos),
                      segs=((q_off, H, hd), (k_off, KH, hd)), theta=1e4)
    tol = 1e-4 if dtype == 'float32' else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    # columns outside the segments are the gathered row, bit for bit
    end = k_off + KH * hd
    rows = ttab[torch.from_numpy(ids).long()]
    assert torch.equal(got[:, :d], rows[:, :d])
    assert torch.equal(got[:, end:], rows[:, end:])


# --------------------------------------------------------- paged_attention
def _paged_case(seed, B, T, KV, G, d, Sc, ps, lengths, null_tail=False):
    """A pool of pages with per-slot tables; slot b holds positions
    [0, lengths[b]) at ring index pos % Sc (wraps when lengths[b] > Sc).
    Unallocated table entries point at the null page 0 (positions -1)."""
    rng = np.random.default_rng(seed)
    P = -(-Sc // ps)
    NP = 1 + B * P
    table = (np.arange(B * P, dtype=np.int32) + 1).reshape(B, P)
    if null_tail:
        table[1, -1] = 0
    cpos = np.full((NP, ps), -1, np.int32)
    for b, n in enumerate(lengths):
        for p in range(max(0, n - Sc), n):
            idx = p % Sc
            page = int(table[b, idx // ps])
            if page:
                cpos[page, idx % ps] = p
    k = rng.standard_normal((NP, ps, KV, d)).astype(np.float32)
    v = rng.standard_normal((NP, ps, KV, d)).astype(np.float32)
    k[0] = v[0] = 0.0
    q = rng.standard_normal((B, T, KV, G, d)).astype(np.float32)
    pos0 = np.array([max(n - T, 0) for n in lengths], np.int32)
    return q, k, v, cpos, table, pos0


@pytest.mark.parametrize('ps', [1, 8, 16])
@pytest.mark.parametrize('window', [0, 5])
@pytest.mark.parametrize('T', [1, 5])
def test_paged_attention_matches_jax(jx, ps, window, T):
    """Ring wraparound (slot 0), a slot ending mid-page with a null-page
    table entry (slot 1) and an empty slot (slot 2, all zeros)."""
    jax, jnp, _, PA = jx
    B, KV, G, d, Sc = 3, 2, 2, 16, 24
    args = _paged_case(0, B, T, KV, G, d, Sc, ps, [Sc + 7, ps + 3, 0],
                       null_tail=True)
    kw = dict(scale=d ** -0.5, window=window)
    want = np.asarray(PA.paged_attention(*map(jnp.asarray, args), **kw,
                                         interpret=True))
    got = paged_attention(*map(torch.from_numpy, args), **kw).numpy()
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    assert not got[2].any()


def test_kernel_tolerance_is_jax_pallas_tol(jx):
    from repro.models.attn_backend import PALLAS_TOL
    assert KERNEL_TOL == PALLAS_TOL


def test_dense_page_helpers_match_jax(jx):
    jax, jnp, _, PA = jx
    for Sc in (1, 11, 24, 96, 256, 4111):
        assert dense_page_split(Sc) == PA.dense_page_split(Sc)
        ps = dense_page_split(Sc)
        np.testing.assert_array_equal(
            dense_identity_table(3, Sc, ps).numpy(),
            np.asarray(PA.dense_identity_table(3, Sc, ps)))
    leaf = torch.arange(2 * 24 * 3).reshape(2, 24, 3)
    pages = dense_as_pages(leaf, 8)
    assert pages.shape == (6, 8, 3) and pages.data_ptr() == leaf.data_ptr()


# ------------------------------------------------------------------- build
def test_build_flags_and_entry_points():
    """sm_90a, no fast math, and every declared C entry point defined in
    its source."""
    flags = ' '.join(build.NVCC_FLAGS)
    assert 'arch=compute_90a,code=sm_90a' in flags
    assert 'fast_math' not in flags and 'fast-math' not in flags
    for name, fns in build.SIGNATURES.items():
        src = (build.CSRC / f'{name}.cu').read_text()
        assert not re.search(r'__(sin|cos|exp)f\s*\(', src), name
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r'\(([^)]*)\)', src)
            assert m, f'{fn} missing from {name}.cu'
            assert len(m.group(1).split(',')) == len(argtypes), fn
        assert build.library_path(name).name.startswith(name + '-')


# ---------------------------------------------------- CUDA kernel vs plain
@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('V,W,N', [(503, 320, 33), (100, 130, 5),
                                   (32000, 10240, 64)])
def test_embed_gather_kernel_bitwise(cuda, V, W, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    tab = torch.randn((V, W), generator=gen, device=cuda).to(dtype)
    ids = torch.randint(0, V, (N,), generator=gen, device=cuda,
                        dtype=torch.int32)
    n0 = embed_gather.launches
    got = embed_gather(tab, ids)
    torch.cuda.synchronize()
    assert embed_gather.launches == n0 + 1
    assert torch.equal(got, embed_gather_plain(tab, ids))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gather_rope_kernel_matches_plain(cuda, dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    V, W, N = 32000, 10240, 64
    tab = torch.randn((V, W), generator=gen, device=cuda).to(dtype)
    ids = torch.randint(0, V, (N,), generator=gen, device=cuda,
                        dtype=torch.int32)
    pos = torch.randint(0, 32768, (N,), generator=gen, device=cuda,
                        dtype=torch.int32)
    kw = dict(segs=((4096, 32, 128), (8192, 8, 128)), theta=1e4)
    got = gather_rope(tab, ids, pos, **kw)
    want = gather_rope_plain(tab, ids, pos, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    rows = tab[ids.long()]
    assert torch.equal(got[:, :4096], rows[:, :4096])
    assert torch.equal(got[:, 9216:], rows[:, 9216:])


@pytest.mark.cuda
@pytest.mark.parametrize('ps', [1, 8, 16])
@pytest.mark.parametrize('window', [0, 5])
@pytest.mark.parametrize('T,d', [(1, 16), (5, 16), (16, 128)])
def test_paged_attention_kernel_matches_plain(cuda, ps, window, T, d):
    B, KV, G, Sc = 3, 2, 4, 24
    args = [torch.from_numpy(a).to(cuda) for a in _paged_case(
        0, B, T, KV, G, d, Sc, ps, [Sc + 7, ps + 3, 0], null_tail=True)]
    kw = dict(scale=d ** -0.5, window=window)
    got = paged_attention(*args, **kw)
    want = paged_attention_plain(*args, **kw)
    torch.testing.assert_close(got, want, **KERNEL_TOL)
    assert not got[2].any()
