"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; those are held
against the JAX kernels as the JAX tests run them here (Pallas in interpret
mode): ``embed_gather`` bitwise, ``gather_rope`` within 1e-4 (fp32) / 3e-2
(bf16), ``paged_attention`` within ``PALLAS_TOL`` (atol = rtol = 2e-4).

``paged_attention`` is also held at glm4-9b's group size (G 16): a 16-token
chunk gives 256 query rows per (slot, kv head). The plain versions of
``fused_page_write`` and ``cow_page_copy`` are held against JAX in
``tests/test_torch_paged.py``; the MLA form of ``paged_attention`` and
``gather_rope`` over MLA segments in ``tests/test_torch_mla.py``.

Tests marked ``cuda`` hold each CUDA kernel against its plain version on a
card and skip without one (bitwise for the two page-maintenance kernels,
also on the int8 cache's five leaves and for the quantizing form of
``fused_page_write``, float K/V in; ``gather_rope`` at N 1, 4 and 64, one
kernel a call after the first; the MLA form of ``paged_attention``
and the 17-segment ``gather_rope`` at deepseek-v2-lite-16b widths; the
int8 form ``paged_attention_quant`` at mistral-7b and glm4-9b widths;
``sharded_paged_attention`` over a mesh of the card repeated, bitwise
against one unsharded launch; at gemma3-1b's head width 256 the split
``paged_attention`` in both forms with its row independence,
``flash_attention``, ``gather_rope`` over 256-wide heads and the
quantizing ``fused_page_write``; ``gather_rope`` over llama3-405b's 136
rotated heads, bitwise). The
int8 form's plain version is held against JAX in
``tests/test_torch_quant.py``. They import nothing of JAX, so on a machine with
only the port they run with:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import itertools
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
                                                 paged_attention_mla,
                                                 paged_attention_plain,
                                                 paged_attention_quant)
from repro_torch.kernels import paged_maintenance as PM
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm_qkv import (rmsnorm_matmul,
                                             rmsnorm_matmul_plain,
                                             rmsnorm_qkv, rmsnorm_qkv_plain)
from repro_torch.models.attn_backend import KERNEL_TOL

from _torch_scenarios import (async_packed_vs_eager_run, clean_after_failed,
                              cow_retaken_run, oov_prompts, quant_write_case,
                              replay_vs_eager_run, serve_outcomes)


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


@pytest.mark.parametrize('T', [1, 16])
def test_paged_attention_group16_matches_jax(jx, T):
    """glm4-9b's grouping (KV 2, G 16) at a 16-token chunk: 256 query rows
    per (slot, kv head), more than one block of the kernel holds."""
    jax, jnp, _, PA = jx
    B, KV, G, d, Sc, ps = 2, 2, 16, 16, 48, 16
    args = _paged_case(1, B, T, KV, G, d, Sc, ps, [40, 17])
    kw = dict(scale=d ** -0.5, window=0)
    want = np.asarray(PA.paged_attention(*map(jnp.asarray, args), **kw,
                                         interpret=True))
    got = paged_attention(*map(torch.from_numpy, args), **kw).numpy()
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


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


# ---------------------------------------------------- rmsnorm_qkv (plain)
RMS_SHAPES = [(64, 64, 64, 32), (128, 128, 256, 64), (33, 96, 96, 24)]
RMS_TOL = {'float32': 1e-5, 'bfloat16': 3e-2}


def _rms_inputs(N, d, q, e, lead=()):
    """x, scale, wq, wk, wv as float32 numpy (the shapes and scales of
    ``tests/test_kernels.py::test_rmsnorm_qkv``)."""
    rng = np.random.default_rng(N + d + q + e)
    x = rng.standard_normal(lead + (N, d)).astype(np.float32)
    scale = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    return (x, scale) + tuple(rng.standard_normal((d, w)).astype(np.float32)
                              for w in (q, e, e))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('N,d,q,e', RMS_SHAPES)
def test_rmsnorm_qkv_plain_matches_jax(jx, N, d, q, e, dtype):
    """The plain rmsnorm_qkv against ``ops.rmsnorm_qkv`` (the Pallas kernel
    in interpret mode) and ``ref.rmsnorm_qkv_ref``; the plain
    rmsnorm_matmul over [Wq|Wk|Wv] equals it."""
    jax, jnp, ops, _ = jx
    from repro.kernels import ref
    arrs = _rms_inputs(N, d, q, e)
    jargs = [jnp.asarray(a).astype(dtype) for a in arrs]
    targs = [torch.from_numpy(a).to(_tdtype(dtype)) for a in arrs]
    got = rmsnorm_qkv(*targs)
    tol = RMS_TOL[dtype]
    for want in (ops.rmsnorm_qkv(*jargs), ref.rmsnorm_qkv_ref(*jargs)):
        for g, w in zip(got, want):
            assert g.dtype == targs[0].dtype
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w.astype(jnp.float32)),
                                       atol=tol, rtol=tol)
    fused = rmsnorm_matmul(targs[0], targs[1], torch.cat(targs[2:], dim=1))
    assert torch.equal(fused, torch.cat(got, dim=1))


def test_rmsnorm_qkv_plain_leading_dims(jx):
    """x (2, 7, 64): outputs keep the leading dims, rows as ``ref``."""
    jax, jnp, ops, _ = jx
    from repro.kernels import ref
    x, scale, wq, wk, wv = _rms_inputs(7, 64, 64, 32, lead=(2,))
    q, k, v = rmsnorm_qkv(*map(torch.from_numpy, (x, scale, wq, wk, wv)))
    assert q.shape == (2, 7, 64) and k.shape == v.shape == (2, 7, 32)
    want = ref.rmsnorm_qkv_ref(*map(jnp.asarray, (x.reshape(-1, 64), scale,
                                                  wq, wk, wv)))
    for g, w in zip((q, k, v), want):
        np.testing.assert_allclose(g.reshape(14, -1).numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)
    jq, _, _ = ops.rmsnorm_qkv(*map(jnp.asarray, (x, scale, wq, wk, wv)))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------ flash_attention (plain)
FLASH_SHAPES = [(1, 128, 2, 2, 32, 0), (2, 256, 4, 2, 32, 0),
                (2, 256, 4, 1, 64, 40), (1, 192, 8, 2, 16, 64),
                (1, 100, 4, 2, 32, 40)]
FLASH_TOL = {'float32': 2e-5, 'bfloat16': 3e-2}


def _assert_flash_close(got, want):
    """The flash kernel against its plain version: ``FLASH_TOL``, and in
    bf16 also chip_smoke.py's limit scaled by the output, |err| <= 0.02
    rms(row) + 0.016 |want|, under which a skipped key tile or a lost
    rescale cannot hide."""
    tol = FLASH_TOL[str(want.dtype)[6:]]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if want.dtype == torch.bfloat16:
        w = want.float()
        limit = 0.02 * w.pow(2).mean(-1, keepdim=True).sqrt() + 0.016 * w.abs()
        share = ((got.float() - w).abs() / limit.clamp_min(1e-30)).max()
        assert share <= 1, f'{share.item():.3f} of the row-scaled limit'


def _flash_inputs(B, S, H, KH, d, seed=0):
    rng = np.random.default_rng(seed + S + H + d)
    return (rng.standard_normal((B, S, H, d)).astype(np.float32),
            rng.standard_normal((B, S, KH, d)).astype(np.float32),
            rng.standard_normal((B, S, KH, d)).astype(np.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B,S,H,KH,d,window', FLASH_SHAPES)
def test_flash_attention_plain_matches_jax(jx, B, S, H, KH, d, window,
                                           dtype):
    """The plain flash_attention (positions = arange) against
    ``ops.flash_attention_bshd(block=64)`` (the Pallas kernel in interpret
    mode) and ``ref.flash_attention_ref``; GQA, windows 40 / 64 and S 100,
    which is not a multiple of 64."""
    jax, jnp, ops, _ = jx
    from repro.kernels import ref
    arrs = _flash_inputs(B, S, H, KH, d)
    jargs = [jnp.asarray(a).astype(dtype) for a in arrs]
    targs = [torch.from_numpy(a).to(_tdtype(dtype)) for a in arrs]
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    got = flash_attention(*targs, pos, window=window)
    assert got.dtype == targs[0].dtype and got.shape == (B, S, H, d)
    tol = FLASH_TOL[dtype]
    for want in (ops.flash_attention_bshd(*jargs, window=window, block=64),
                 ref.flash_attention_ref(*jargs, window=window)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


def test_flash_attention_plain_masks_by_position():
    """The mask reads positions, not indices: positions shifted by an
    offset give the same output, and a sequence whose positions skip
    ahead sees through the window by position; ``causal=False`` with a
    window keeps future keys."""
    q, k, v = map(torch.from_numpy, _flash_inputs(2, 70, 4, 2, 16))
    pos = torch.arange(70, dtype=torch.int32)[None].expand(2, 70)
    base = flash_attention(q, k, v, pos, window=9)
    torch.testing.assert_close(flash_attention(q, k, v, pos + 1000,
                                               window=9), base)
    gap = pos.clone()
    gap[:, 40:] += 9                 # keys before index 40 leave the window
    out = flash_attention(q, k, v, gap, window=9)
    torch.testing.assert_close(out[:, :40], base[:, :40])
    alone = flash_attention(q[:, 40:], k[:, 40:], v[:, 40:], gap[:, 40:],
                            window=9)
    torch.testing.assert_close(out[:, 40:], alone)
    # non-causal: the window bounds the past only, as in the TPU kernel
    ahead = flash_attention(q, k, v, pos, causal=False, window=9)
    everything = flash_attention(q, k, v, pos, causal=False)
    assert not torch.allclose(ahead, base)
    torch.testing.assert_close(ahead[:, -1], base[:, -1])
    torch.testing.assert_close(ahead[:, 0], everything[:, 0])


def test_flash_attention_plain_applies_index_rule():
    """The rules hold on indices as well as on positions — the CUDA kernel
    skips key tiles by index — so positions that do not rise give the same
    answer on the card and here: equal positions leave the index mask alone,
    and falling positions leave each query only its own key."""
    B, S, H, KH, d = 2, 70, 4, 2, 16
    q, k, v = map(torch.from_numpy, _flash_inputs(B, S, H, KH, d))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    flat = torch.zeros_like(pos)
    for window in (0, 9):
        torch.testing.assert_close(
            flash_attention(q, k, v, flat, window=window),
            flash_attention(q, k, v, pos, window=window))
    own = flash_attention(q, k, v, S - 1 - pos, window=9)
    want = v.repeat_interleave(H // KH, dim=2)
    torch.testing.assert_close(own, want)


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
def test_gather_kernels_ids_out_of_range(cuda):
    """ids -1, -V, -V - 1, V, V + 7 (and int32's extremes) among valid ones,
    fp32 and bf16: ``embed_gather`` bitwise its plain version
    (``jnp.take``: wrapped rows, NaN rows), ``gather_rope`` within its
    tolerance with NaN where the plain version has NaN; no device-side
    assert."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    V, W = 503, 320
    ids = torch.tensor([5, -1, -V, -V - 1, V, V + 7, 0, V - 1, 2 ** 31 - 1,
                        -2 ** 31], dtype=torch.int32, device=cuda)
    pos = torch.arange(len(ids), dtype=torch.int32, device=cuda) * 37
    bad = torch.tensor([0, 0, 0, 1, 1, 1, 0, 0, 1, 1], dtype=torch.bool,
                       device=cuda)
    kw = dict(segs=((64, 4, 32),), theta=1e4)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        tab = torch.randn((V, W), generator=gen, device=cuda).to(dtype)
        got, want = embed_gather(tab, ids), embed_gather_plain(tab, ids)
        rope = gather_rope(tab, ids, pos, **kw)
        rope_want = gather_rope_plain(tab, ids, pos, **kw)
        torch.cuda.synchronize()
        for g, w in ((got, want), (rope, rope_want)):
            assert torch.equal(g.isnan(), bad[:, None].expand_as(g))
            assert torch.equal(w.isnan(), bad[:, None].expand_as(w))
        assert torch.equal(got[~bad], want[~bad])
        assert torch.equal(got[1], tab[V - 1]) and torch.equal(got[2], tab[0])
        torch.testing.assert_close(rope[~bad].float(),
                                   rope_want[~bad].float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
def test_out_of_vocab_fails_only_its_request_on_card(cuda):
    """The twin of ``tests/test_torch_vocab.py``'s engine tests on the card
    (fp32 smoke weights, the table's fused read, the kernel backend; dense
    mistral-7b and paged glm4-9b): the out-of-vocabulary request fails
    with ``nonfinite_logits``, the others (an id of -1 among them) finish;
    with one slot a clean request after the failed one gets a fresh
    engine's tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServingEngine
    for arch, paged in (('mistral_7b', False), ('glm4_9b', True)):
        model = Model(get_smoke_config(arch))
        params = model.init(0, device=cuda, dtype=torch.float32)
        V = model.cfg.vocab_size
        kw = dict(max_seq=32, chunk_size=4,
                  precomputed=model.build_table(params),
                  fused_gather_rope=True, attn_backend='cuda', device=cuda)
        if paged:
            kw.update(prefix_cache=True, page_size=4)
        got = serve_outcomes(ServingEngine(model, params, max_slots=2, **kw),
                             Request, oov_prompts(V))
        assert [g[:2] for g in got] == [('FAILED', 'nonfinite_logits')] + \
            [('FINISHED', None)] * 3, arch
        after, fresh, pages = clean_after_failed(
            lambda: ServingEngine(model, params, max_slots=1,
                                  num_pages=9 if paged else None, **kw), V)
        assert after[0][:2] == ('FAILED', 'nonfinite_logits')
        assert after[1] == fresh[0], arch
        if paged:
            assert pages[0] & pages[1], pages


def _device_kernels(fn) -> int:
    """Device kernels (and copies) that one call of ``fn`` runs, by the
    profiler's trace; a trace with no device activity at all recorded
    nothing and is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return 0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gather_rope_kernel_matches_plain(cuda, dtype, tol):
    """mistral-7b rows (q 32 x 128, k 8 x 128 of width 10240) at N 1, 4
    and 64; a second call launches one kernel and nothing else (the
    frequencies are built once)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    V, W = 32000, 10240
    tab = torch.randn((V, W), generator=gen, device=cuda).to(dtype)
    kw = dict(segs=((4096, 32, 128), (8192, 8, 128)), theta=1e4)
    for N in (1, 4, 64):
        ids = torch.randint(0, V, (N,), generator=gen, device=cuda,
                            dtype=torch.int32)
        pos = torch.randint(0, 32768, (N,), generator=gen, device=cuda,
                            dtype=torch.int32)
        got = gather_rope(tab, ids, pos, **kw)
        want = gather_rope_plain(tab, ids, pos, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        rows = tab[ids.long()]
        assert torch.equal(got[:, :4096], rows[:, :4096])
        assert torch.equal(got[:, 9216:], rows[:, 9216:])
        n0 = gather_rope.launches
        assert _device_kernels(lambda: gather_rope(tab, ids, pos, **kw)) == 1
        assert gather_rope.launches == n0 + 1


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


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, KERNEL_TOL['atol']),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('T', [1, 16])
def test_paged_attention_kernel_group16(cuda, dtype, tol, T):
    """glm4-9b's KV 2, G 16, d 128 through a scattered page table: 256
    query rows per (slot, kv head) at T 16, in four row tiles."""
    B, KV, G, d, Sc, ps = 4, 2, 16, 128, 256, 16
    q, k, v, cpos, table, pos0 = _paged_case(2, B, T, KV, G, d, Sc, ps,
                                             [200, 37, 0, 256])
    perm = np.random.default_rng(0).permutation(k.shape[0] - 1) + 1
    inv = np.empty_like(perm)
    inv[perm - 1] = np.arange(1, k.shape[0])
    k[1:], v[1:], cpos[1:] = k[perm], v[perm], cpos[perm]
    table = np.where(table > 0, inv[np.maximum(table, 1) - 1], 0) \
        .astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, cpos, table,
                                                    pos0)]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    got = paged_attention(*args, scale=d ** -0.5)
    want = paged_attention_plain(*args, scale=d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize('N', [4, 64])
def test_gather_rope_kernel_mla_segments(cuda, dtype, tol, N):
    """deepseek-v2-lite-16b rows (width 5696): 17 segments of width 64,
    each head's q_pe slice between its q_nope slices, plus k_pe."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    V, W, d, H, dn, dr, r = 1000, 5696, 2048, 16, 128, 64, 512
    tab = torch.randn((V, W), generator=gen, device=cuda).to(dtype)
    ids = torch.randint(0, V, (N,), generator=gen, device=cuda,
                        dtype=torch.int32)
    pos = torch.randint(0, 32768, (N,), generator=gen, device=cuda,
                        dtype=torch.int32)
    segs = tuple((d + h * (dn + dr) + dn, 1, dr) for h in range(H)) \
        + ((d + H * (dn + dr) + r, 1, dr),)
    rotated = torch.zeros(W, dtype=torch.bool, device=cuda)
    for off, _, w in segs:
        rotated[off:off + w] = True
    for n in (1, N):
        n0 = gather_rope.launches
        got = gather_rope(tab, ids[:n], pos[:n], segs=segs, theta=1e4)
        want = gather_rope_plain(tab, ids[:n], pos[:n], segs=segs, theta=1e4)
        torch.cuda.synchronize()
        assert gather_rope.launches == n0 + 1
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        rows = tab[ids[:n].long()]
        assert torch.equal(got[:, ~rotated], rows[:, ~rotated])
        assert _device_kernels(lambda: gather_rope(
            tab, ids[:n], pos[:n], segs=segs, theta=1e4)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_gather_rope_kernel_llama3_405b_heads(cuda, dtype):
    """llama3-405b's row (width 34816: x 16384, 128 q heads and 8 k heads of
    128, v 1024), 136 rotated heads at theta 500k, N 1, 4, 64 and 512:
    bitwise the plain version, one device kernel a call; more heads than
    ``MAX_HEADS`` raise."""
    from repro_torch.kernels.gather_rope import MAX_HEADS
    gen = torch.Generator(device=cuda).manual_seed(3)
    V, W, d, H, KV, hd = 1000, 34816, 16384, 128, 8, 128
    tab = torch.randn((V, W), generator=gen, device=cuda).to(dtype)
    kw = dict(segs=((d, H, hd), (d + H * hd, KV, hd)), theta=5e5)
    for N in (1, 4, 64, 512):
        ids = torch.randint(0, V, (N,), generator=gen, device=cuda,
                            dtype=torch.int32)
        pos = torch.randint(0, 131072, (N,), generator=gen, device=cuda,
                            dtype=torch.int32)
        got = gather_rope(tab, ids, pos, **kw)
        assert torch.equal(got, gather_rope_plain(tab, ids, pos, **kw)), N
        assert _device_kernels(lambda: gather_rope(tab, ids, pos, **kw)) == 1
    assert H + KV <= MAX_HEADS
    with pytest.raises(ValueError, match='rotated heads'):
        gather_rope(tab, ids, pos, segs=((0, MAX_HEADS + 1, 128),),
                    theta=5e5)


@pytest.mark.cuda
@pytest.mark.parametrize('page_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('T', [1, 16])
def test_paged_attention_mla_kernel_matches_plain(cuda, page_dtype, T):
    """deepseek-v2-lite-16b's MLA attend: fp32 queries (B, T, 1, 16, 576)
    over latent pages (ckv 512, kpe 64) through a scattered table; slots
    of 300 / 271 / 0 / 365 tokens."""
    B, H, r, dr, ps = 4, 16, 512, 64, 16
    lengths = [300, 271, 0, 365]
    gen = torch.Generator(device=cuda).manual_seed(3)
    P = 2048 // ps
    NP = 1 + B * P
    perm = torch.randperm(NP - 1, generator=gen, device=cuda) + 1
    table = perm.view(B, P).to(torch.int32).clone()
    cpos = torch.full((NP, ps), -1, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lengths):
        table[b, -(-n // ps):] = 0
        p = torch.arange(n, device=cuda)
        cpos[table[b, p // ps].long(), p % ps] = p.to(torch.int32)
    ckv = torch.randn((NP, ps, 1, r), generator=gen, device=cuda) \
        .to(page_dtype)
    kpe = torch.randn((NP, ps, 1, dr), generator=gen, device=cuda) \
        .to(page_dtype)
    ckv[0], kpe[0] = 0, 0
    q = torch.randn((B, T, 1, H, r + dr), generator=gen, device=cuda)
    pos0 = torch.tensor([max(n - T, 0) for n in lengths], dtype=torch.int32,
                        device=cuda)
    kw = dict(scale=192 ** -0.5)
    n0 = (paged_attention.launches, paged_attention_mla.launches)
    got = paged_attention(q, ckv, None, cpos, table, pos0, k2_pages=kpe,
                          mla_split=r, **kw)
    want = paged_attention_plain(q, ckv, None, cpos, table, pos0,
                                 k2_pages=kpe, mla_split=r, **kw)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention_mla.launches) == \
        (n0[0], n0[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (B, T, 1, H, r)
    torch.testing.assert_close(got, want, **KERNEL_TOL)
    assert not got[2].any()


# ----------------------------------------- page maintenance: CUDA vs plain
@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ps,Sc,T', [(16, 2048, 16), (16, 2048, 1),
                                     (8, 11, 4), (4, 10, 4)])
def test_fused_page_write_kernel_bitwise(cuda, dtype, ps, Sc, T):
    B, KV, d = 4, 2, 128
    P = -(-Sc // ps)
    NP = 1 + B * P + 4
    gen = torch.Generator(device=cuda).manual_seed(0)
    k = torch.randn((NP, ps, KV, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((NP, ps, KV, d), generator=gen, device=cuda).to(dtype)
    pos = torch.randint(0, 99, (NP, ps), generator=gen, device=cuda,
                        dtype=torch.int32)
    k[0], v[0], pos[0] = 0, 0, -1
    table = (torch.arange(B * P, dtype=torch.int32, device=cuda)
             .view(B, P) + 1)
    table[3, 1:] = 0                           # unallocated blocks
    pos0 = torch.tensor([Sc - 2, 0, 5, 0], dtype=torch.int32, device=cuda)
    n_valid = torch.tensor([T, max(T - 1, 1), T, 0], dtype=torch.int32,
                           device=cuda)
    pending = torch.tensor([int(table[1, 0]), NP - 1, NP - 2, 0],
                           dtype=torch.int32, device=cuda)
    vals = [torch.randn((B, T, KV, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2)]
    pos_t = PM.chunk_positions(pos0, T)
    jobs = PM.build_jobs(pos0, n_valid, table, Sc, ps, T, pending)
    want = [PM.fused_page_write_plain(x.clone(), val, jobs, Sc=Sc, fill=f)
            for x, val, f in ((k, vals[0], 0), (v, vals[1], 0),
                              (pos, pos_t, -1))]
    n0 = PM.fused_page_write.launches
    got = PM.fused_page_write([k, v, pos], [vals[0], vals[1], pos_t], jobs,
                              Sc=Sc, fills=[0, 0, -1])
    torch.cuda.synchronize()
    assert PM.fused_page_write.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_quantizing_page_write_kernel_bitwise(cuda):
    """The quantizing form (float K/V in, int8 rows and bf16 scales out, in
    the write's own launch) bitwise its plain version (``quantize_rows`` +
    the plain write, torch's CUDA kernels) on all five leaves at glm4-9b
    shapes (KV 2, hd 128): page sizes 1 and 16, T 1 and 16, a linear table
    of 2048 and a ring of 27, fp32 and bf16 values, with rows of NaN,
    zeros, .5 ties, bf16's largest values and an amax at which division and
    reciprocal differ (``tests/_torch_scenarios.py``). One launch a
    write."""
    names = ('k', 'v', 'k_scale', 'v_scale', 'pos')
    pairs = [(0, 2), (1, 3)]
    for ps, Sc, T, dtype in itertools.product(
            (1, 16), (2048, 27), (1, 16), (torch.float32, torch.bfloat16)):
        pool, k, v, pos0, nv, table, pending = quant_write_case(
            ps + Sc + T, ps=ps, Sc=Sc, T=T, KV=2, hd=128)
        leaves = [torch.from_numpy(pool[nm]).to(cuda) for nm in names]
        for i in (2, 3):
            leaves[i] = leaves[i].to(torch.bfloat16)
        jobs = PM.build_jobs(*(torch.from_numpy(a).to(cuda)
                               for a in (pos0, nv, table)), Sc, ps, T,
                             torch.from_numpy(pending).to(cuda))
        pos_t = PM.chunk_positions(torch.from_numpy(pos0).to(cuda), T)
        vals = [torch.from_numpy(k).to(cuda).to(dtype),
                torch.from_numpy(v).to(cuda).to(dtype), None, None, pos_t]
        fills = [PM.leaf_fill(nm) for nm in names]
        want = [PM.fused_page_write_plain(x.clone(), y, jobs, Sc=Sc, fill=f)
                for x, y, f in zip(leaves, PM.quantized_values(vals, pairs),
                                   fills)]
        n0 = PM.fused_page_write.launches
        PM.fused_page_write(leaves, vals, jobs, Sc=Sc, fills=fills,
                            quantize=pairs)
        torch.cuda.synchronize()
        assert PM.fused_page_write.launches == n0 + 1
        for nm, g, w in zip(names, leaves, want):
            bits = torch.int16 if 'scale' in nm else g.dtype
            assert torch.equal(g.view(bits), w.view(bits)), \
                (ps, Sc, T, dtype, nm)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cow_page_copy_kernel_bitwise(cuda, dtype):
    reps, NP, ps, KV, d = 39, 20, 16, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(1)
    cache = {'k': torch.randn((reps, NP, ps, KV, d), generator=gen,
                              device=cuda).to(dtype),
             'pos': torch.randint(0, 99, (reps, NP, ps), generator=gen,
                                  device=cuda, dtype=torch.int32)}
    for src, dst, rem in ((3, 7, 0), (4, 8, 7), (5, 9, 16)):
        want = {nm: x.clone() for nm, x in cache.items()}
        for nm, x in want.items():
            sdr = torch.tensor([[src + r * NP, dst + r * NP, rem]
                                for r in range(reps)], dtype=torch.int32,
                               device=cuda)
            PM.cow_page_copy_plain(x.view((reps * NP,) + x.shape[2:]), sdr,
                                   fill=PM.leaf_fill(nm))
        n0 = PM.cow_page_copy.launches
        PM.cow_copy_cache(cache, src, dst, rem, reps=reps)
        torch.cuda.synchronize()
        assert PM.cow_page_copy.launches == n0 + 1
        for nm in cache:
            assert torch.equal(cache[nm], want[nm]), (nm, rem)


# ---------------------------------------------------- the int8 KV cache
def _int8_pages(gen, lead, KV, d, cuda):
    k = torch.randint(-127, 128, lead + (KV, d), generator=gen, device=cuda,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, lead + (KV, d), generator=gen, device=cuda,
                      dtype=torch.int8)
    ks = (torch.rand(lead + (KV,), generator=gen, device=cuda) * 0.08
          + 0.005).to(torch.bfloat16)
    vs = (torch.rand(lead + (KV,), generator=gen, device=cuda) * 0.08
          + 0.005).to(torch.bfloat16)
    return k, v, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('T', [1, 16])
@pytest.mark.parametrize('shape', ['mistral', 'glm4'])
def test_paged_attention_quant_kernel_matches_plain(cuda, shape, T, dtype):
    """int8 pages with bf16 scales: mistral-7b (KV 8, G 4) on dense rings
    of 512 as identity-table pages, window 300; glm4-9b (KV 2, G 16)
    through a scattered table. fp32 queries within KERNEL_TOL; bf16 ones
    within KERNEL_TOL plus one bf16 step of the output (2^-7 of its
    magnitude): two fp32 sums that differ in their last bits may round to
    neighbouring bf16 values."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    lengths = [700, 300, 0, 549] if shape == 'mistral' else [300, 271, 0,
                                                             365]
    B, d = 4, 128
    if shape == 'mistral':
        KV, G, Sc, window = 8, 4, 512, 300
        k, v, ks, vs = _int8_pages(gen, (B, Sc), KV, d, cuda)
        cpos = torch.full((B, Sc), -1, dtype=torch.int32, device=cuda)
        for b, n in enumerate(lengths):
            p = torch.arange(max(0, n - Sc), n, device=cuda)
            cpos[b, p % Sc] = p.to(torch.int32)
        ps = dense_page_split(Sc)
        k, v, ks, vs, cpos = (dense_as_pages(x, ps)
                              for x in (k, v, ks, vs, cpos))
        table = dense_identity_table(B, Sc, ps, cuda)
    else:
        KV, G, ps, window = 2, 16, 16, 0
        P = 2048 // ps
        NP = 1 + B * P
        k, v, ks, vs = _int8_pages(gen, (NP, ps), KV, d, cuda)
        table = (torch.randperm(NP - 1, generator=gen, device=cuda) + 1) \
            .view(B, P).to(torch.int32)
        cpos = torch.full((NP, ps), -1, dtype=torch.int32, device=cuda)
        for b, n in enumerate(lengths):
            table[b, -(-n // ps):] = 0
            p = torch.arange(n, device=cuda)
            cpos[table[b, p // ps].long(), p % ps] = p.to(torch.int32)
    q = torch.randn((B, T, KV, G, d), generator=gen, device=cuda).to(dtype)
    pos0 = torch.tensor([max(n - T, 0) for n in lengths], dtype=torch.int32,
                        device=cuda)
    kw = dict(scale=d ** -0.5, window=window)
    n0 = (paged_attention.launches, paged_attention_quant.launches)
    got = paged_attention_quant(q, k, v, ks, vs, cpos, table, pos0, **kw)
    want = paged_attention_plain(q, k, v, cpos, table, pos0, k_scale_pages=ks,
                                 v_scale_pages=vs, **kw)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention_quant.launches) == \
        (n0[0], n0[1] + 1)
    assert got.dtype == dtype and not got[2].any()
    lim = KERNEL_TOL['atol'] + KERNEL_TOL['rtol'] * want.float().abs()
    if dtype is torch.bfloat16:
        lim = lim + want.float().abs() * 2.0 ** -7
    assert bool(((got.float() - want.float()).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize('H', [2, 4])
@pytest.mark.parametrize('form', ['float32', 'bfloat16', 'int8'])
def test_sharded_paged_attention_kernel_bitwise(cuda, form, H):
    """``sharded_paged_attention`` on a mesh of the card repeated H times
    (KV 4, G 4, d 128, a scattered table, T 16): bitwise one unsharded
    launch, H shard launches, and within the unsharded checks' tolerance of
    its plain version (KERNEL_TOL; bf16 2e-2); the int8 form takes fp32
    queries. ``tests/test_torch_sharded.py`` holds the same split against
    JAX on the CPU."""
    from repro_torch.kernels.paged_attention import (
        sharded_paged_attention, sharded_paged_attention_plain)
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh((1, H), devices=[cuda] * H)
    B, T, KV, G, d, Sc, ps = 3, 16, 4, 4, 128, 64, 16
    q, k, v, cpos, table, pos0 = _paged_case(6, B, T, KV, G, d, Sc, ps,
                                             [64, 29, 0])
    perm = np.random.default_rng(1).permutation(k.shape[0] - 1) + 1
    inv = np.empty_like(perm)
    inv[perm - 1] = np.arange(1, k.shape[0])
    k[1:], v[1:], cpos[1:] = k[perm], v[perm], cpos[perm]
    table = np.where(table > 0, inv[np.maximum(table, 1) - 1], 0) \
        .astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, cpos, table,
                                                    pos0)]
    kw = dict(scale=d ** -0.5)
    tol = dict(KERNEL_TOL)
    if form == 'bfloat16':
        args = [a.bfloat16() if a.is_floating_point() else a for a in args]
        tol = dict(atol=2e-2, rtol=2e-2)
    if form == 'int8':
        gen = torch.Generator(device=cuda).manual_seed(5)
        args[1], args[2], ks, vs = _int8_pages(gen, tuple(k.shape[:2]), KV,
                                               d, cuda)
        kw.update(k_scale_pages=ks, v_scale_pages=vs)
        one = paged_attention_quant(*args[:3], ks, vs, *args[3:],
                                    scale=kw['scale'])
    else:
        one = paged_attention(*args, **kw)
    n0 = sharded_paged_attention.launches
    got = sharded_paged_attention(*args, mesh=mesh, **kw)
    plain = sharded_paged_attention_plain(*args, mesh=mesh, **kw)
    torch.cuda.synchronize()
    assert sharded_paged_attention.launches == n0 + H
    assert got.dtype == args[0].dtype and torch.equal(got, one)
    torch.testing.assert_close(got.float(), plain.float(), **tol)
    assert not got[2].any()


@pytest.mark.cuda
def test_paged_attention_quant_kernel_rejects_int8_without_scales(cuda):
    k = torch.zeros((4, 8, 2, 16), dtype=torch.int8, device=cuda)
    q = torch.zeros((1, 1, 2, 2, 16), device=cuda)
    cpos = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    table = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    pos0 = torch.zeros((1,), dtype=torch.int32, device=cuda)
    n0 = paged_attention.launches
    with pytest.raises(ValueError, match='need k_scale_pages'):
        paged_attention(q, k, k, cpos, table, pos0, scale=1.0)
    assert paged_attention.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize('ps,Sc,T', [(16, 2048, 16), (16, 2048, 1),
                                     (16, 27, 16)])
def test_fused_page_write_kernel_int8_leaves_bitwise(cuda, ps, Sc, T):
    """glm4-9b's five int8 pool leaves in one launch: int8 k / v, bf16
    k_scale / v_scale rows of 4 bytes (KV 2), int32 positions."""
    B, KV, d = 4, 2, 128
    P = -(-Sc // ps)
    NP = 1 + B * P + 4
    gen = torch.Generator(device=cuda).manual_seed(5)
    leaves = list(_int8_pages(gen, (NP, ps), KV, d, cuda)) + [
        torch.randint(0, 99, (NP, ps), generator=gen, device=cuda,
                      dtype=torch.int32)]
    fills = [0, 0, 0, 0, -1]
    for x, f in zip(leaves, fills):
        x[0] = f
    table = (torch.arange(B * P, dtype=torch.int32, device=cuda)
             .view(B, P) + 1)
    pos0 = torch.tensor([Sc - 2, 0, 5, 0], dtype=torch.int32, device=cuda)
    n_valid = torch.tensor([T, max(T - 1, 1), T, 0], dtype=torch.int32,
                           device=cuda)
    pending = torch.tensor([int(table[1, 0]), NP - 1, 0], dtype=torch.int32,
                           device=cuda)
    vals = list(_int8_pages(gen, (B, T), KV, d, cuda)) + [
        PM.chunk_positions(pos0, T)]
    jobs = PM.build_jobs(pos0, n_valid, table, Sc, ps, T, pending)
    want = [PM.fused_page_write_plain(x.clone(), val, jobs, Sc=Sc, fill=f)
            for x, val, f in zip(leaves, vals, fills)]
    n0 = PM.fused_page_write.launches
    PM.fused_page_write(leaves, vals, jobs, Sc=Sc, fills=fills)
    torch.cuda.synchronize()
    assert PM.fused_page_write.launches == n0 + 1
    for g, w in zip(leaves, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cow_page_copy_kernel_int8_leaves_bitwise(cuda):
    reps, NP, ps, KV, d = 39, 20, 16, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(6)
    names = ('k', 'v', 'k_scale', 'v_scale', 'pos')
    cache = dict(zip(names, list(_int8_pages(gen, (reps, NP, ps), KV, d,
                                             cuda))
                     + [torch.randint(0, 99, (reps, NP, ps), generator=gen,
                                      device=cuda, dtype=torch.int32)]))
    for src, dst, rem in ((3, 7, 0), (4, 8, 7), (5, 9, 16)):
        sdr = torch.tensor([[src + r * NP, dst + r * NP, rem]
                            for r in range(reps)], dtype=torch.int32,
                           device=cuda)
        want = {nm: PM.cow_page_copy_plain(
            x.clone().view((reps * NP,) + x.shape[2:]), sdr,
            fill=PM.leaf_fill(nm)) for nm, x in cache.items()}
        n0 = PM.cow_page_copy.launches
        PM.cow_copy_cache(cache, src, dst, rem, reps=reps)
        torch.cuda.synchronize()
        assert PM.cow_page_copy.launches == n0 + 1
        for nm, x in cache.items():
            assert torch.equal(x.view(want[nm].shape), want[nm]), (nm, rem)


@pytest.mark.cuda
def test_cow_page_copy_kernel_pythia_pages_bitwise(cuda):
    """pythia-6.9b's pages (32 kv heads x 128: 128 KB a bf16 leaf page, 64
    KB an int8 one) stacked over its 31 body layers, one job a layer: bf16
    k / v / pos, then the five int8 leaves (k, v int8; k_scale, v_scale bf16
    of 64-byte rows; pos), at rem 0, 7 and 16 and at rem -3 and 20 (all
    fill, all copy), bitwise the plain version, one launch a copy."""
    reps, NP, ps, KV, d = 31, 8, 16, 32, 128
    gen = torch.Generator(device=cuda).manual_seed(9)
    pos = torch.randint(0, 99, (reps, NP, ps), generator=gen, device=cuda,
                        dtype=torch.int32)
    bf16 = {'k': torch.randn((reps, NP, ps, KV, d), generator=gen,
                             device=cuda).to(torch.bfloat16),
            'v': torch.randn((reps, NP, ps, KV, d), generator=gen,
                             device=cuda).to(torch.bfloat16),
            'pos': pos.clone()}
    int8 = dict(zip(('k', 'v', 'k_scale', 'v_scale'),
                    _int8_pages(gen, (reps, NP, ps), KV, d, cuda)),
                pos=pos.clone())
    for cache in (bf16, int8):
        for src, dst, rem in ((1, 5, 0), (2, 6, 7), (3, 7, 16), (1, 4, -3),
                              (2, 4, 20)):
            sdr = torch.tensor([[src + r * NP, dst + r * NP, rem]
                                for r in range(reps)], dtype=torch.int32,
                               device=cuda)
            want = {nm: PM.cow_page_copy_plain(
                x.clone().view((reps * NP,) + x.shape[2:]), sdr,
                fill=PM.leaf_fill(nm)) for nm, x in cache.items()}
            n0 = PM.cow_page_copy.launches
            PM.cow_copy_cache(cache, src, dst, rem, reps=reps)
            torch.cuda.synchronize()
            assert PM.cow_page_copy.launches == n0 + 1
            for nm, x in cache.items():
                assert torch.equal(x.view(want[nm].shape), want[nm]), \
                    (sorted(cache), nm, rem)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('N,d,q,e', RMS_SHAPES + [(5, 4096, 4096, 1024),
                                                  (70, 4096, 4096, 256),
                                                  (1, 40, 20, 12),
                                                  (9, 72, 40, 8),
                                                  (130, 64, 200, 72)])
def test_rmsnorm_matmul_kernel_matches_plain(cuda, N, d, q, e, dtype):
    """rmsnorm_qkv (three weight pointers, one launch) and rmsnorm_matmul
    (one matrix) against their plain versions at the tolerances of
    ``tests/test_kernels.py`` (1e-5 fp32, 3e-2 bf16), ragged N and W
    included; the model widths with fan-in scaled weights."""
    arrs = _rms_inputs(N, d, q, e)
    if d >= 1024:
        arrs = arrs[:2] + tuple(w / np.sqrt(d) for w in arrs[2:])
    x, scale, wq, wk, wv = [torch.from_numpy(np.ascontiguousarray(a))
                            .to(cuda, dtype) for a in arrs]
    tol = RMS_TOL[str(dtype)[6:]]
    n0 = rmsnorm_matmul.launches
    got = rmsnorm_qkv(x, scale, wq, wk, wv)
    torch.cuda.synchronize()
    assert rmsnorm_matmul.launches == n0 + 1
    for g, w in zip(got, rmsnorm_qkv_plain(x, scale, wq, wk, wv)):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
    one = rmsnorm_matmul(x, scale, wk)
    torch.testing.assert_close(one.float(),
                               rmsnorm_matmul_plain(x, scale, wk).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,S,H,KH,d,window', FLASH_SHAPES + [
    (1, 1000, 32, 8, 128, 300), (1, 577, 32, 2, 128, 0),
    (1, 130, 64, 1, 64, 0), (3, 77, 4, 4, 16, 5), (2, 65, 6, 3, 32, 64),
    (1, 300, 8, 8, 128, 0)])
def test_flash_attention_kernel_matches_plain(cuda, B, S, H, KH, d, window,
                                              dtype):
    """The flash kernel against its plain version (``_assert_flash_close``),
    ragged S included; mistral-7b and glm4-9b head layouts (G 4 and 16,
    d 128), the largest group (64 query heads per kv head, one position a
    block), heads without grouping, batches of 2-3, a window of one tile;
    and on positions that do not rise."""
    q, k, v = [torch.from_numpy(a).to(cuda, dtype)
               for a in _flash_inputs(B, S, H, KH, d)]
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None] \
        .expand(B, S).contiguous()
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    want = flash_attention_plain(q, k, v, pos, window=window)
    assert got.dtype == dtype
    _assert_flash_close(got, want)
    shifted = flash_attention(q, k, v, pos + 37, window=window)
    torch.testing.assert_close(shifted, got)
    # positions that do not rise: the index rules keep kernel and plain equal
    gen = torch.Generator(device=cuda).manual_seed(S)
    odd = torch.randint(0, S, (B, S), generator=gen, device=cuda,
                        dtype=torch.int32)
    _assert_flash_close(flash_attention(q, k, v, odd, window=window),
                        flash_attention_plain(q, k, v, odd, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('window', [0, 40])
def test_flash_attention_kernel_not_causal(cuda, window, dtype):
    """``causal=False``: every key to S (the window bounds only the past),
    ragged S, against the plain version."""
    B, S, H, KH, d = 2, 150, 8, 2, 64
    q, k, v = [torch.from_numpy(a).to(cuda, dtype)
               for a in _flash_inputs(B, S, H, KH, d)]
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None] \
        .expand(B, S).contiguous()
    got = flash_attention(q, k, v, pos, causal=False, window=window)
    _assert_flash_close(got, flash_attention_plain(q, k, v, pos, causal=False,
                                                   window=window))
    assert not torch.equal(got, flash_attention(q, k, v, pos, window=window))


def _flash_bad_args(cuda):
    """Inputs the kernel does not take, each with the reason: the wrapper
    must raise on them rather than fall back."""
    def qkv(H=4, KH=2, d=32, dtype=torch.bfloat16):
        return [torch.zeros((1, 8, n, d), device=cuda, dtype=dtype)
                for n in (H, KH, KH)]
    pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    q, k, v = qkv()
    return {
        'head_width': (*qkv(d=48), pos),
        'group': (*qkv(H=130, KH=2), pos),
        'dtype': (q, k.float(), v, pos),
        'half': (*qkv(dtype=torch.float16), pos),
        'strided': (q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                    pos),
        'positions_int64': (q, k, v, pos.long()),
        'positions_on_cpu': (q, k, v, pos.cpu()),
    }


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['head_width', 'group', 'dtype', 'half',
                                  'strided', 'positions_int64',
                                  'positions_on_cpu'])
def test_flash_attention_kernel_rejects(cuda, case):
    """On CUDA tensors the wrapper launches the kernel or raises: a head
    width, group, dtype, layout or positions the kernel does not take, or
    tensors on two devices, raise ValueError and launch nothing."""
    args = _flash_bad_args(cuda)[case]
    n0 = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(*args)
    assert flash_attention.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['dtype', 'scale_shape', 'weight_rows',
                                  'strided_weight', 'weight_on_cpu'])
def test_rmsnorm_matmul_kernel_rejects(cuda, case):
    """As for flash_attention: mixed dtypes, a scale or weight of the
    wrong shape, a strided weight and tensors on two devices raise
    ValueError and launch nothing."""
    N, d, W = 4, 64, 32
    x = torch.zeros((N, d), device=cuda, dtype=torch.bfloat16)
    scale = torch.ones(d, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((d, W), device=cuda, dtype=torch.bfloat16)
    args = {'dtype': (x, scale, w.float()),
            'scale_shape': (x, scale[:-1], w),
            'weight_rows': (x, scale, w[:-1]),
            'strided_weight': (x, scale, torch.zeros(
                (W, d), device=cuda, dtype=torch.bfloat16).t()),
            'weight_on_cpu': (x, scale, w.cpu())}[case]
    n0 = rmsnorm_matmul.launches
    with pytest.raises(ValueError):
        rmsnorm_matmul(*args)
    assert rmsnorm_matmul.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', [False, True])
def test_cow_page_freed_and_retaken_in_one_pass_on_card(cuda, kv_quant):
    """The twin of ``tests/test_torch_paged.py``'s test of the same name:
    on the card, through fused_page_write, the deferred clears and
    cow_page_copy, the page freed and taken again in one admission pass
    leaves ``_pending_clear`` when it is copied on write, and the greedy
    tokens equal the dense engine's."""
    got, dense, seen = cow_retaken_run('cuda', 'cuda', kv_quant)
    assert seen['cow'] and seen['page'] not in seen['after']
    assert seen['before'].count(seen['page']) == 1
    assert got == dense


@pytest.mark.cuda
def test_programs_replay_matches_eager_on_card(cuda):
    """The twin of ``tests/test_torch_programs.py``'s scenario test: on the
    card the 16-slot engine captures each step shape's CUDA graph and
    replays it; greedy tokens, score logits and pools are bitwise those of
    the engine that runs every step eagerly."""
    got, want, info = replay_vs_eager_run('cuda')
    assert info['buckets'] == {8}
    assert info['graphs'] > 0 and info['replays'] > 0, info
    assert got == want


@pytest.mark.cuda
def test_async_packed_replays_match_eager_on_card(cuda):
    """The twin of ``tests/test_torch_async.py``'s scenario test: on the
    card the 16-slot engine with packing and the async loop replays its
    CUDA graphs one step ahead of the host; greedy tokens are those of the
    synchronous unpacked engine that runs every step eagerly, and score
    logits agree within fp32 rounding (the packed grid's matmuls have
    other row counts, so cuBLAS may take other algorithms)."""
    got, want, got_logits, want_logits, info = \
        async_packed_vs_eager_run('cuda')
    assert info['packed'] and info['graphs'] > 0 and info['replays'] > 0
    assert got == want
    for a, b in zip(got_logits, want_logits):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


# ------------------------------------------------- gemma3 widths (d 256)
def _split_pages(cuda, gen, quant, B, T, window, lengths, KV=1, G=4,
                 d=256):
    """gemma3-1b's attend (KV 1, G 4, d 256; other heads by ``KV``, ``G``
    and ``d``): a ``window`` ring of 527 (512 + chunk 16 - 1) entries a
    slot as identity-table pages of one key, or, with no window,
    2048-token slots through a scattered table of 16-token pages; bf16
    pages, or int8 with bf16 scales. -> (q, pages, scales or None, cpos,
    table, pos0)."""
    if window:
        Sc = window + 15
        lead = (B, Sc)
    else:
        ps, P = 16, 2048 // 16
        NP = 1 + B * P
        lead = (NP, ps)
    if quant:
        k, v, ks, vs = _int8_pages(gen, lead, KV, d, cuda)
        scales = (ks, vs)
    else:
        k, v = (torch.randn(lead + (KV, d), generator=gen, device=cuda)
                .bfloat16() for _ in range(2))
        scales = None
    if window:
        cpos = torch.full((B, Sc), -1, dtype=torch.int32, device=cuda)
        for b, n in enumerate(lengths):
            p = torch.arange(max(0, n - Sc), n, device=cuda)
            cpos[b, p % Sc] = p.to(torch.int32)
        ps = dense_page_split(Sc)
        k, v, cpos = (dense_as_pages(x, ps) for x in (k, v, cpos))
        if quant:
            scales = tuple(dense_as_pages(x, ps) for x in scales)
        table = dense_identity_table(B, Sc, ps, cuda)
    else:
        table = (torch.randperm(NP - 1, generator=gen, device=cuda) + 1) \
            .view(B, P).to(torch.int32)
        cpos = torch.full((NP, ps), -1, dtype=torch.int32, device=cuda)
        for b, n in enumerate(lengths):
            table[b, -(-n // ps):] = 0
            p = torch.arange(n, device=cuda)
            cpos[table[b, p // ps].long(), p % ps] = p.to(torch.int32)
    q = torch.randn((B, T, KV, G, d), generator=gen, device=cuda).bfloat16()
    pos0 = torch.tensor([max(n - T, 0) for n in lengths], dtype=torch.int32,
                        device=cuda)
    return q, (k, v), scales, cpos, table, pos0


def _check_split(cuda, fn_args, quant, T, kw):
    """One split attend (dense or int8 form) of ``_split_pages``' arguments
    against the plain version (dense within 2e-2; int8 within KERNEL_TOL
    and one bf16 step), slot 2 (empty) all zeros, one launch; at T 16 row
    t bitwise a one-token call at pos0 + t."""
    q, (k, v), scales, cpos, table, pos0 = fn_args
    fn = paged_attention_quant if quant else paged_attention
    sc = () if scales is None else scales
    n0 = fn.launches
    got = fn(q, k, v, *sc, cpos, table, pos0, **kw)
    want = paged_attention_plain(
        q, k, v, cpos, table, pos0, **kw,
        **({} if scales is None else dict(k_scale_pages=scales[0],
                                          v_scale_pages=scales[1])))
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and not got[2].any()
    if quant:
        lim = KERNEL_TOL['atol'] + KERNEL_TOL['rtol'] \
            * want.float().abs() + want.float().abs() * 2.0 ** -7
        assert bool(((got.float() - want.float()).abs() <= lim).all())
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=2e-2, rtol=2e-2)
    if T == 16:
        for t in range(T):
            one = fn(q[:, t:t + 1].contiguous(), k, v, *sc, cpos, table,
                     pos0 + t, **kw)
            assert torch.equal(one, got[:, t:t + 1]), t


@pytest.mark.cuda
@pytest.mark.parametrize('quant', [False, True])
@pytest.mark.parametrize('window', [0, 512])
def test_paged_split_kernel_d256(cuda, window, quant):
    """The split kernels (dense and int8 forms, bf16 q) at gemma3-1b's
    shapes, d 256 (four warps share a tile of query rows): a 512-window
    ring and a global layer, T 1 and 16, against the plain version (dense
    within 2e-2; int8 within KERNEL_TOL and one bf16 step), an empty slot
    all zeros, one launch a call; and row t of the 16-token call bitwise a
    one-token call at pos0 + t."""
    gen = torch.Generator(device=cuda).manual_seed(256 + window + quant)
    lengths = [1300, 700, 0, 515] if window else [1800, 333, 0, 1031]
    for T in (1, 16):
        _check_split(cuda, _split_pages(cuda, gen, quant, 4, T, window,
                                        lengths), quant, T,
                     dict(scale=256 ** -0.5, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('S,window', [(1000, 512), (577, 0)])
def test_flash_attention_kernel_d256(cuda, S, window, dtype):
    """flash_attention at gemma3-1b's heads (H 4 over KV 1, d 256; in bf16
    two warps share a tile's rows and the ring holds 2 stages) against the
    plain version (``_assert_flash_close``), ragged S, a local layer's
    window of 512 and a global one."""
    q, k, v = [torch.from_numpy(a).to(cuda, dtype)
               for a in _flash_inputs(1, S, 4, 1, 256)]
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None].contiguous()
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    _assert_flash_close(got, flash_attention_plain(q, k, v, pos,
                                                   window=window))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gather_rope_kernel_gemma_rows(cuda, dtype, tol):
    """gemma3-1b rows (width 2688: x 1152, q 4 x 256, k 1 x 256, v 256)
    at theta 1e4 (layer 0 is local), N 1, 4 and 64: rotated heads of 256
    against the plain version, x and v copied bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    V, W = 4096, 2688
    tab = torch.randn((V, W), generator=gen, device=cuda).to(dtype)
    kw = dict(segs=((1152, 4, 256), (2176, 1, 256)), theta=1e4)
    for N in (1, 4, 64):
        ids = torch.randint(0, V, (N,), generator=gen, device=cuda,
                            dtype=torch.int32)
        pos = torch.randint(0, 32768, (N,), generator=gen, device=cuda,
                            dtype=torch.int32)
        got = gather_rope(tab, ids, pos, **kw)
        torch.testing.assert_close(
            got.float(), gather_rope_plain(tab, ids, pos, **kw).float(),
            atol=tol, rtol=tol)
        rows = tab[ids.long()]
        assert torch.equal(got[:, :1152], rows[:, :1152])
        assert torch.equal(got[:, 2432:], rows[:, 2432:])


def _check_quantizing_write(cuda, KV, hd, rings):
    """The quantizing ``fused_page_write`` at pool rows of KV heads x hd
    bitwise its plain version on the five leaves, page size 16, T 1 and
    16, a linear table of 2048 and a ring of each of ``rings``, fp32 and
    bf16 values, with the edge rows of ``tests/_torch_scenarios.py``."""
    names = ('k', 'v', 'k_scale', 'v_scale', 'pos')
    pairs = [(0, 2), (1, 3)]
    for Sc, T, dtype in itertools.product(
            (2048,) + rings, (1, 16), (torch.float32, torch.bfloat16)):
        pool, k, v, pos0, nv, table, pending = quant_write_case(
            Sc + T, ps=16, Sc=Sc, T=T, KV=KV, hd=hd)
        leaves = [torch.from_numpy(pool[nm]).to(cuda) for nm in names]
        for i in (2, 3):
            leaves[i] = leaves[i].to(torch.bfloat16)
        jobs = PM.build_jobs(*(torch.from_numpy(a).to(cuda)
                               for a in (pos0, nv, table)), Sc, 16, T,
                             torch.from_numpy(pending).to(cuda))
        pos_t = PM.chunk_positions(torch.from_numpy(pos0).to(cuda), T)
        vals = [torch.from_numpy(k).to(cuda).to(dtype),
                torch.from_numpy(v).to(cuda).to(dtype), None, None, pos_t]
        fills = [PM.leaf_fill(nm) for nm in names]
        want = [PM.fused_page_write_plain(x.clone(), y, jobs, Sc=Sc, fill=f)
                for x, y, f in zip(leaves, PM.quantized_values(vals, pairs),
                                   fills)]
        n0 = PM.fused_page_write.launches
        PM.fused_page_write(leaves, vals, jobs, Sc=Sc, fills=fills,
                            quantize=pairs)
        torch.cuda.synchronize()
        assert PM.fused_page_write.launches == n0 + 1
        for nm, g, w in zip(names, leaves, want):
            bits = torch.int16 if 'scale' in nm else g.dtype
            assert torch.equal(g.view(bits), w.view(bits)), \
                (Sc, T, dtype, nm)


@pytest.mark.cuda
def test_quantizing_page_write_kernel_d256_bitwise(cuda):
    """The quantizing ``fused_page_write`` at gemma3-1b's pool rows (KV 1,
    hd 256: one head read by 32 lanes), a ring of 527."""
    _check_quantizing_write(cuda, 1, 256, (527,))


@pytest.mark.cuda
def test_quantizing_page_write_kernel_d64_bitwise(cuda):
    """The quantizing ``fused_page_write`` at internvl2-1b's pool rows (KV
    2, hd 64: a head's 8 bf16 chunks over 8 lanes, so 4 heads share a warp
    and the lanes of the 2 past the kv heads hold zeros through the amax
    shuffles), a ring of 27."""
    _check_quantizing_write(cuda, 2, 64, (27,))


# ------------------------------------- internvl2-1b widths (d 64, G 7)
@pytest.mark.cuda
@pytest.mark.parametrize('quant', [False, True])
def test_paged_split_kernel_d64_group7(cuda, quant):
    """The split kernels (dense and int8 forms, bf16 q) at internvl2-1b's
    heads: 14 query heads over 2 kv heads (G 7, an odd group: a tile's
    rows map to (t, g) by / 7 and % 7), d 64, 2048-token slots through a
    scattered table of 16-token pages, T 1 and 16 (112 query rows a kv
    head), against the plain version; T 16 rows bitwise one-token
    calls."""
    gen = torch.Generator(device=cuda).manual_seed(64 + quant)
    for T in (1, 16):
        _check_split(cuda, _split_pages(cuda, gen, quant, 4, T, 0,
                                        [1800, 333, 0, 1031], KV=2, G=7,
                                        d=64), quant, T,
                     dict(scale=64 ** -0.5, window=0))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('S', [4096, 1000])
def test_flash_attention_kernel_d64_group7(cuda, S, dtype):
    """flash_attention at internvl2-1b's heads (H 14 over KV 2: G 7, 18
    positions of 7 heads in a 126-row block, d 64), causal, S 4096 (its
    Model.apply) and a ragged 1000, against the plain version."""
    q, k, v = [torch.from_numpy(a).to(cuda, dtype)
               for a in _flash_inputs(1, S, 14, 2, 64)]
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None].contiguous()
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    _assert_flash_close(got, flash_attention_plain(q, k, v, pos))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gather_kernels_internvl_and_whisper_rows(cuda, dtype, tol):
    """gather_rope over internvl2-1b's rows (width 2048: x 896, q 14 x 64,
    k 2 x 64, v 128; theta 1e6) against the plain version, x and v
    bitwise; embed_gather at its width and at whisper-tiny-rope's 1536
    (x, q, k, v of 384), bitwise; N 1, 4 and 64."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    V = 4096
    tab = torch.randn((V, 2048), generator=gen, device=cuda).to(dtype)
    wtab = torch.randn((V, 1536), generator=gen, device=cuda).to(dtype)
    kw = dict(segs=((896, 14, 64), (1792, 2, 64)), theta=1e6)
    for N in (1, 4, 64):
        ids = torch.randint(0, V, (N,), generator=gen, device=cuda,
                            dtype=torch.int32)
        pos = torch.randint(0, 32768, (N,), generator=gen, device=cuda,
                            dtype=torch.int32)
        got = gather_rope(tab, ids, pos, **kw)
        torch.testing.assert_close(
            got.float(), gather_rope_plain(tab, ids, pos, **kw).float(),
            atol=tol, rtol=tol)
        rows = tab[ids.long()]
        assert torch.equal(got[:, :896], rows[:, :896])
        assert torch.equal(got[:, 1920:], rows[:, 1920:])
        for t in (tab, wtab):
            assert torch.equal(embed_gather(t, ids), t[ids.long()])


@pytest.mark.cuda
@pytest.mark.parametrize('N', [1, 4, 64, 4096])
def test_rmsnorm_matmul_kernel_internvl_width(cuda, N):
    """rmsnorm_qkv at internvl2-1b's layer 0 (d 896 -> q 896, k 128, v 128:
    W 1152) in bf16, every form its N takes, against the plain version
    within the bf16 tolerance of ``tests/test_kernels.py``."""
    arrs = _rms_inputs(N, 896, 896, 128)
    arrs = arrs[:2] + tuple(w / np.sqrt(896) for w in arrs[2:])
    x, scale, wq, wk, wv = [torch.from_numpy(np.ascontiguousarray(a))
                            .to(cuda, torch.bfloat16) for a in arrs]
    tol = RMS_TOL['bfloat16']
    n0 = rmsnorm_matmul.launches
    got = rmsnorm_qkv(x, scale, wq, wk, wv)
    torch.cuda.synchronize()
    assert rmsnorm_matmul.launches == n0 + 1
    for g, w in zip(got, rmsnorm_qkv_plain(x, scale, wq, wk, wv)):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
