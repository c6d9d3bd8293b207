"""The port's int8 KV cache (``kv_quant=True``) against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function and
its port. Tolerances, each with its reason:

- ``_quantize`` and every int8 cache write (``cache_update``,
  ``cache_update_chunk`` with ring wraparound, the paged chunk write through
  the job-list path with deferred clears): **bitwise** — the same fp32
  inputs give the same int8 values and bf16 scales.
- The int8 form of ``paged_attention`` (plain version) against the JAX
  kernel in interpret mode, and the reference ``_attend_lanes``: within
  ``PALLAS_TOL`` (atol = rtol = 2e-4) — identical int8 pages, so only the
  fp32 summation order differs.
- Model logits, port against JAX's reference backend: within **atol 1e-3,
  rtol 2e-2**, greedy tokens equal. K/V computed by two frameworks differ
  in their last fp32 bits, and a value that lands on the other side of an
  int8 rounding step moves by a whole step (amax / 127). JAX's own two
  backends differ by up to 4.06e-4 absolute and 1.08e-2 relative on the
  ``gqa`` config below (``tests/test_attn_backend.py::
  test_model_chunked_decode_parity_dense[True-gqa]``, which fails its 2e-4
  bound for that reason); the bound here is that gap with headroom.
- Inside the port, bitwise: chunked equals token-by-token, paged equals
  dense, and deepseek-v2-lite-16b (MLA latent caches, which ignore
  ``kv_quant``) gives the same tokens with and without it.
- Engine greedy tokens equal the JAX engine's with ``kv_quant=True``: the
  mistral-7b smoke config on dense ring caches, the glm4-9b smoke config
  through the paged pool with prefix hits, copy-on-write and preemption.

The ``cuda``-marked tests of the int8 kernel and of the page-maintenance
kernels on int8 and scale leaves are in ``tests/test_torch_kernels.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JaxModelConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import paged_attention as JPA
from repro.models import attention as JA
from repro.models.attn_backend import PALLAS_TOL
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.config import ModelConfig
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import paged_maintenance as PM
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_quant)
from repro_torch.models import attention as A
from repro_torch.models.attn_backend import CUDA, REFERENCE
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, RequestStatus, ServingEngine

from _torch_scenarios import quant_write_case

# model logits across frameworks in int8: JAX's own backends differ by
# 4.06e-4 / 1.08e-2 on the gqa config (int8 step flips); see the docstring
INT8_MODEL_TOL = dict(atol=1e-3, rtol=2e-2)
PS, MAX_SEQ = 8, 64
LEAVES = ('k', 'v', 'k_scale', 'v_scale', 'pos')


def _np(x):
    """A leaf as numpy, bf16 widened to fp32 (exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _assert_caches_equal(got, want, names=LEAVES):
    assert sorted(got) == sorted(want) == sorted(names)
    for nm in names:
        g, w = _np(got[nm]), _np(want[nm])
        assert g.dtype == w.dtype, (nm, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=nm)


def _bf16(a):
    """numpy fp32 values rounded to bf16 (and back to fp32)."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _int8_cache(rng, lead, KV, hd, pos_hi=9):
    """A written int8 cache of leading shape ``lead``: random int8 K/V,
    positive bf16 scales, positions in [-1, pos_hi)."""
    return {'k': rng.integers(-127, 128, lead + (KV, hd)).astype(np.int8),
            'v': rng.integers(-127, 128, lead + (KV, hd)).astype(np.int8),
            'k_scale': _bf16(np.abs(rng.standard_normal(lead + (KV,))) * 0.05
                             + 1e-3),
            'v_scale': _bf16(np.abs(rng.standard_normal(lead + (KV,))) * 0.05
                             + 1e-3),
            'pos': rng.integers(-1, pos_hi, lead).astype(np.int32)}


def _to_jax(cache):
    return {nm: jnp.asarray(a).astype(jnp.bfloat16) if 'scale' in nm
            else jnp.asarray(a) for nm, a in cache.items()}


def _to_torch(cache):
    return {nm: torch.from_numpy(a.copy()).to(torch.bfloat16)
            if 'scale' in nm else torch.from_numpy(a.copy())
            for nm, a in cache.items()}


# --------------------------------------------------------------- _quantize
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantize_matches_jax_bitwise(dtype):
    """Random rows, an all-zero row (the 1e-8 scale floor), a row with
    amax 127 (scale exactly 1) whose values sit on .5 boundaries (round
    half to even) and at ±amax."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = [127, 2.5, -3.5, 0.5, 1.5, -0.5, -127, 126.5,
                  -2.5, 3.5, 4.5, -4.5, 64.5, 0, 5.5, -5.5]
    x[1, 2, 1] = 1e-30                       # below the floor times 127
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))) \
        .to(getattr(torch, dtype))
    jq, js = JA._quantize(jx)
    tq, ts = A._quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    assert tq[0, 1, 0, :4].tolist() == [127, 2, -4, 0]


# ------------------------------------------------------------------ caches
def test_make_cache_quant_matches_jax():
    jcfg, cfg = jax_smoke_config('mistral_7b'), get_smoke_config('mistral_7b')
    want = JA.make_cache(jcfg, 3, 40, window=jcfg.window,
                         dtype=jnp.float32, quant=True, chunk=4)
    got = A.make_cache(cfg, 3, 40, window=cfg.window, dtype=torch.float32,
                       quant=True, chunk=4, device='cpu')
    _assert_caches_equal(got, want)
    assert got['k'].dtype == torch.int8
    assert got['k_scale'].shape == (3, A.cache_len(cfg.window, 40, 4),
                                    cfg.num_kv_heads)
    jpool = JA.make_paged_cache(jcfg, 9, PS, dtype=jnp.float32, quant=True)
    pool = A.make_paged_cache(cfg, 9, PS, dtype=torch.float32, quant=True,
                              device='cpu')
    _assert_caches_equal(pool, jpool)
    assert pool['v_scale'].shape == (9, PS, cfg.num_kv_heads)


def test_cache_update_quant_matches_jax_bitwise():
    rng = np.random.default_rng(1)
    B, Sc, KV, hd = 3, 7, 2, 16
    cache = _int8_cache(rng, (B, Sc), KV, hd)
    k = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    v[1] = 0.0                                 # the scale floor
    pos = np.array([3, 9, 13], np.int32)       # 9 and 13 wrap the ring
    want = JA.cache_update(_to_jax(cache), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(pos))
    got = A.cache_update(_to_torch(cache), torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(pos))
    _assert_caches_equal(got, want)


@pytest.mark.parametrize('Sc,T,n_valid', [(11, 4, [4, 3, 0]),
                                          (5, 8, [8, 7, 2]),
                                          (3, 4, [1, 0, 4])])
def test_cache_update_chunk_quant_matches_jax_bitwise(Sc, T, n_valid):
    """Ring writes of a chunk, laps of the ring inside one chunk
    included: every leaf, scales and positions too, as JAX's."""
    rng = np.random.default_rng(Sc)
    B, KV, hd = 3, 2, 16
    cache = _int8_cache(rng, (B, Sc), KV, hd)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    pos0 = np.array([9, 2, 17], np.int32)
    nv = np.array(n_valid, np.int32)
    want = JA.cache_update_chunk(_to_jax(cache), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos0),
                                 jnp.asarray(nv))
    got = A.cache_update_chunk(_to_torch(cache), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos0),
                               torch.from_numpy(nv))
    _assert_caches_equal(got, want)


def test_ring_wraparound_write_on_windowed_config_matches_jax():
    """The mistral-7b smoke config's windowed ring (window 8, chunk 4):
    chunk after chunk through the model's write path until both slots'
    rings have wrapped (slot 0 twice), every leaf bitwise after every
    chunk."""
    jcfg, cfg = jax_smoke_config('mistral_7b'), get_smoke_config('mistral_7b')
    B, T, S = 2, 4, 64
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    jc = JA.make_cache(jcfg, B, S, window=jcfg.window, dtype=jnp.float32,
                       quant=True, chunk=T)
    tc = A.make_cache(cfg, B, S, window=cfg.window, dtype=torch.float32,
                      quant=True, chunk=T, device='cpu')
    Sc = tc['pos'].shape[1]
    rng = np.random.default_rng(4)
    pos = np.zeros(B, np.int32)
    for step in range(3 * Sc // T + 1):
        k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
        v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
        nv = np.array([T, (step % T) + 1], np.int32)
        jc = JA.cache_update_chunk(jc, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos), jnp.asarray(nv))
        A.chunk_write(tc, torch.from_numpy(k), torch.from_numpy(v),
                      torch.from_numpy(pos), torch.from_numpy(nv),
                      window=cfg.window,
                      paged=None)
        _assert_caches_equal(tc, jc)
        pos = pos + nv
    assert pos.min() > Sc and pos.max() > 2 * Sc


@pytest.mark.parametrize('T', [1, 4])
def test_paged_chunk_write_quant_matches_jax_bitwise(T):
    """The port's paged chunk write through the job-list path (the plain
    ``fused_page_write``, the step's pending pages cleared on the way)
    equals JAX's eager clears + ``paged_update_chunk`` on all five leaves,
    and the port's own plain scatter path with eager clears."""
    rng = np.random.default_rng(10 + T)
    B, KV, hd, P = 3, 2, 16, MAX_SEQ // PS
    NP = 1 + B * P + 2
    pool = _int8_cache(rng, (NP, PS), KV, hd, pos_hi=99)
    for nm in pool:
        pool[nm][0] = PM.leaf_fill(nm)
    table = np.zeros((B, P), np.int32)
    table[0, :3], table[1, :1], table[2, :2] = [1, 2, 3], [4], [5, 6]
    pos0 = np.array([14, 0, 6], np.int32)     # slot 1 starts a fresh page
    nv = np.array([T, T, 0], np.int32)
    pending = np.array([4, NP - 1, 0], np.int32)   # 0 pads the list
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)

    jpool = _to_jax(pool)
    jpool = {nm: x.at[jnp.asarray(pending[:2])].set(PM.leaf_fill(nm))
             for nm, x in jpool.items()}
    want = JA.paged_update_chunk(jpool, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos0), jnp.asarray(nv),
                                 jnp.asarray(table), MAX_SEQ)
    tk, tv, tp0, tnv = map(torch.from_numpy, (k, v, pos0, nv))
    paged = A.PageTables(torch.from_numpy(table),
                         torch.from_numpy(table[:, :0]), 0,
                         torch.from_numpy(pending))
    fused = _to_torch(pool)
    A.chunk_write(fused, tk, tv, tp0, tnv, window=0,
                  paged=paged.with_jobs(tp0, tnv, PS, T), backend=CUDA)
    _assert_caches_equal(fused, want)
    eager = _to_torch(pool)
    for nm, x in eager.items():
        x[torch.from_numpy(pending[:2]).long()] = PM.leaf_fill(nm)
    A.chunk_write(eager, tk, tv, tp0, tnv, window=0, paged=paged,
                  backend=REFERENCE)
    for nm in LEAVES:
        assert torch.equal(fused[nm], eager[nm]), nm


def _same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    """Bitwise equal, a NaN equal to a NaN whatever its bits (torch's CPU
    bf16 conversion gives NaN 0xFFFF, JAX's 0x7FC0)."""
    nan = np.isnan(got.astype(np.float32))
    if not np.array_equal(nan, np.isnan(want.astype(np.float32))):
        return False
    bits = {2: np.int16, 4: np.int32, 1: np.int8}[got.dtype.itemsize]
    return np.array_equal(got.view(bits)[~nan], want.view(bits)[~nan])


def test_quantizing_page_write_matches_jax_bitwise():
    """The quantizing form of ``fused_page_write`` (float K/V in, the
    plain version here: ``quantize_rows`` + the plain write) against JAX's
    ``_quantize`` + ``fused_page_write`` (Pallas, interpret mode) on all
    five leaves: page sizes 1 and 16, fp32 and bf16 values, modes 0/1/2,
    a ring whose last page runs past its end (the vbase rule), and rows of
    NaN, zeros, .5 ties, bf16's largest values and an amax at which
    division and reciprocal differ. int8 values and positions bitwise;
    scales bitwise with NaN equal to NaN. JAX's kernel gathers by a one-hot
    matmul, so a NaN lane would reach every row written from its slot's
    chunk: the NaN row is its slot's only written lane."""
    from repro.kernels import paged_maintenance as JPM
    KV, hd, T = 2, 16, 4
    for (ps, Sc), dtype in [((1, 11), 'float32'), ((1, 11), 'bfloat16'),
                            ((16, 27), 'float32'), ((16, 27), 'bfloat16')]:
        pool, k, v, pos0, nv, table, pending = quant_write_case(
            ps + Sc, ps=ps, Sc=Sc, T=T, KV=KV, hd=hd)
        tjobs = PM.build_jobs(*map(torch.from_numpy, (pos0, nv, table)), Sc,
                              ps, T, torch.from_numpy(pending))
        assert set(tjobs[:, 4].tolist()) == {0, 1, 2}, tjobs
        jobs = jnp.asarray(tjobs.numpy())
        pos_t = pos0[:, None] + np.arange(T, dtype=np.int32)[None]
        jk, jv = (jnp.asarray(x).astype(dtype) for x in (k, v))
        (kq, ks), (vq, vs) = JA._quantize(jk), JA._quantize(jv)
        jvals = {'k': kq, 'v': vq, 'k_scale': ks, 'v_scale': vs,
                 'pos': jnp.asarray(pos_t)}
        want = {nm: JPM.fused_page_write(x, jvals[nm].astype(x.dtype), jobs,
                                         Sc=Sc, fill=PM.leaf_fill(nm),
                                         interpret=True)
                for nm, x in _to_jax(pool).items()}
        got = _to_torch(pool)
        names = list(got)
        tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (k, v))
        vals = {'k': tk, 'v': tv, 'k_scale': None, 'v_scale': None,
                'pos': torch.from_numpy(pos_t)}
        n0 = PM.fused_page_write.launches
        PM.fused_page_write([got[nm] for nm in names],
                            [vals[nm] for nm in names], tjobs, Sc=Sc,
                            fills=[PM.leaf_fill(nm) for nm in names],
                            quantize=[(names.index('k'),
                                       names.index('k_scale')),
                                      (names.index('v'),
                                       names.index('v_scale'))])
        assert PM.fused_page_write.launches == n0
        for nm in names:
            g, w = got[nm], np.asarray(want[nm])
            if 'scale' in nm:                    # bf16 widened: exact
                g, w = g.float(), w.astype(np.float32)
            assert _same_bits(g.numpy(), w), (ps, dtype, nm)
        # the edge rows landed where the case put them
        page, row = _slot_row(table[2], pos0[2], Sc, ps)
        assert not got['k'][page, row, 0].any()
        assert got['k_scale'][page, row, 0].isnan()
        page, row = _slot_row(table[0], pos0[0] + min(1, T - 1), Sc, ps)
        assert got['k_scale'][page, row, KV - 1] == \
            torch.tensor(1e-8).to(torch.bfloat16)
        page, row = _slot_row(table[0], pos0[0], Sc, ps)
        assert got['v'][page, row, 0, :4].tolist() == [127, 4, -2, 2]


def _slot_row(table_row, pos, Sc, ps):
    """(page, row) that ring position ``pos`` of a slot lands on."""
    idx = int(pos) % Sc
    return int(table_row[idx // ps]), idx % ps


# ---------------------------------------------------------------- attention
def _quant_pages(seed, B, T, KV, G, d, Sc, ps, lengths, scattered):
    """int8 pages with bf16 scales of slots holding ``lengths`` tokens at
    ring index pos % Sc; an identity table over a dense view, or pages
    drawn at random from the pool. Unallocated blocks map to page 0."""
    rng = np.random.default_rng(seed)
    P = -(-Sc // ps)
    NP = 1 + B * P
    table = (np.arange(B * P, dtype=np.int32) + 1).reshape(B, P)
    if scattered:
        table = (rng.permutation(B * P) + 1).astype(np.int32).reshape(B, P)
    else:
        table -= 1                              # identity: page b * P + j
        NP = B * P
    pages = _int8_cache(rng, (NP, ps), KV, d)
    pages['pos'][:] = -1
    for b, n in enumerate(lengths):
        for p in range(max(0, n - Sc), n):
            idx = p % Sc
            pages['pos'][table[b, idx // ps], idx % ps] = p
    q = rng.standard_normal((B, T, KV, G, d)).astype(np.float32)
    pos0 = np.array([max(n - T, 0) for n in lengths], np.int32)
    return q, pages, table, pos0


@pytest.mark.parametrize('scattered', [False, True])
@pytest.mark.parametrize('window', [0, 5])
@pytest.mark.parametrize('T,G', [(1, 1), (1, 4), (4, 1), (4, 4)])
def test_paged_attention_quant_plain_matches_jax(scattered, window, T, G):
    """Ring wraparound (slot 0), a slot ending mid-page (slot 1), an empty
    slot (slot 2, zeros); identity-table and scattered pages."""
    B, KV, d, Sc, ps = 3, 2, 16, 24, 8
    q, pages, table, pos0 = _quant_pages(T * 10 + G, B, T, KV, G, d, Sc, ps,
                                         [Sc + 7, ps + 3, 0], scattered)
    kw = dict(scale=d ** -0.5, window=window)
    jp = _to_jax(pages)
    want = np.asarray(JPA.paged_attention(
        jnp.asarray(q), jp['k'], jp['v'], jp['pos'], jnp.asarray(table),
        jnp.asarray(pos0), k_scale_pages=jp['k_scale'],
        v_scale_pages=jp['v_scale'], interpret=True, **kw))
    tp = _to_torch(pages)
    n0 = paged_attention_quant.launches
    got = paged_attention_quant(
        torch.from_numpy(q), tp['k'], tp['v'], tp['k_scale'], tp['v_scale'],
        tp['pos'], torch.from_numpy(table), torch.from_numpy(pos0), **kw)
    assert paged_attention_quant.launches == n0      # the CPU: no launch
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **PALLAS_TOL)
    assert not got[2].any()


def test_paged_attention_quant_bf16_queries_keep_their_dtype():
    B, T, KV, G, d, Sc, ps = 2, 4, 2, 4, 16, 16, 8
    q, pages, table, pos0 = _quant_pages(5, B, T, KV, G, d, Sc, ps, [9, 16],
                                         False)
    tp = _to_torch(pages)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    got = paged_attention_quant(qb, tp['k'], tp['v'], tp['k_scale'],
                                tp['v_scale'], tp['pos'],
                                torch.from_numpy(table),
                                torch.from_numpy(pos0), scale=d ** -0.5)
    want = paged_attention_quant(qb.float(), tp['k'], tp['v'], tp['k_scale'],
                                 tp['v_scale'], tp['pos'],
                                 torch.from_numpy(table),
                                 torch.from_numpy(pos0), scale=d ** -0.5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_wrappers_reject_int8_without_scales_and_scales_without_int8():
    """The dtype checks run before the device dispatch, so on the CPU as
    on the card an int8 cache never attends without its scales."""
    B, T, KV, G, d, Sc, ps = 2, 1, 2, 2, 16, 16, 8
    q, pages, table, pos0 = _quant_pages(6, B, T, KV, G, d, Sc, ps, [9, 16],
                                         False)
    tp = _to_torch(pages)
    args = (torch.from_numpy(table), torch.from_numpy(pos0))
    with pytest.raises(ValueError, match='need k_scale_pages'):
        paged_attention(torch.from_numpy(q), tp['k'], tp['v'], tp['pos'],
                        *args, scale=1.0)
    with pytest.raises(ValueError, match='need k_scale_pages'):
        paged_attention_quant(torch.from_numpy(q), tp['k'], tp['v'], None,
                              tp['v_scale'], tp['pos'], *args, scale=1.0)
    fk, fv = tp['k'].float(), tp['v'].float()
    with pytest.raises(ValueError, match='int8 K/V pages only'):
        paged_attention_quant(torch.from_numpy(q), fk, fv, tp['k_scale'],
                              tp['v_scale'], tp['pos'], *args, scale=1.0)


def test_attend_lanes_quant_matches_jax():
    """The reference attend over an int8 cache (scores times k_scale, then
    the scale; probabilities times v_scale), ring entries with -1 and a
    window, within PALLAS_TOL."""
    jcfg, cfg = jax_smoke_config('mistral_7b'), get_smoke_config('mistral_7b')
    rng = np.random.default_rng(3)
    B, T, Sc = 3, 2, 12
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    cache = _int8_cache(rng, (B, Sc), KV, hd, pos_hi=20)
    q = rng.standard_normal((B, T, KV, G, hd)).astype(np.float32)
    pos_t = np.array([[10, 11], [3, 4], [19, 20]], np.int32)
    for window in (0, 8):
        want = JA._attend_lanes(jnp.asarray(q), _to_jax(cache),
                                jnp.asarray(pos_t), jcfg, window)
        got = A._attend_lanes(torch.from_numpy(q), _to_torch(cache),
                              torch.from_numpy(pos_t), cfg, window)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **PALLAS_TOL)


# ------------------------------------------------------------ model parity
def _ab_cfg(cls, kind):
    """The gqa / local configs of tests/test_attn_backend.py."""
    base = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=211, max_seq_len=256,
                dtype='float32')
    if kind == 'gqa':
        return cls(name='ab-gqa', arch_class='dense', **base)
    return cls(name='ab-local', arch_class='dense',
               pattern=('global', 'local'), window=8, **base)


@pytest.fixture(scope='module')
def ab_models():
    memo = {}

    def get(kind):
        if kind not in memo:
            jm = JaxModel(_ab_cfg(JaxModelConfig, kind))
            jp = jm.init(jax.random.PRNGKey(0))
            tm = Model(_ab_cfg(ModelConfig, kind))
            tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
            memo[kind] = (jm, jp, tm, tp)
        return memo[kind]
    return get


@pytest.mark.parametrize('kind', ['gqa', 'local'])
def test_model_chunked_decode_int8_matches_jax(ab_models, kind):
    """Whole-prompt chunked decode (prompt 20 > ring 8 + slack on the
    local layer) over int8 dense caches: the port's logits, through both
    backends (on the CPU the cuda backend runs the int8 kernel's plain
    version), against JAX's reference backend within INT8_MODEL_TOL, and
    equal greedy tokens at every position."""
    jm, jp, tm, tp = ab_models(kind)
    B, P, T = 2, 20, 4
    toks = np.random.default_rng(1).integers(3, 200, (B, P)).astype(np.int32)

    def run(step, make, zeros, full):
        states, logits = make(), []
        for p in range(0, P, T):
            n = min(T, P - p)
            block = zeros((B, T))
            block[:, :n] = toks[:, p:p + n]
            lg, states = step(block, states, full(p), full(n))
            logits.append(np.asarray(lg)[:, :n])
        return np.concatenate(logits, 1)

    want = run(lambda blk, st, p, n: jm.decode_step(
        jp, jnp.asarray(blk), st, p, n_valid=n, attn_backend='reference'),
        lambda: jm.make_states(B, 32, jnp.float32, kv_quant=True, chunk=T),
        lambda s: np.zeros(s, np.int32),
        lambda x: jnp.full((B,), x, jnp.int32))
    for backend in ('reference', 'cuda'):
        got = run(lambda blk, st, p, n: tm.decode_step(
            tp, torch.from_numpy(blk), st, p, n_valid=n,
            attn_backend=backend),
            lambda: tm.make_states(B, 32, torch.float32, chunk=T,
                                   device='cpu', kv_quant=True),
            lambda s: np.zeros(s, np.int32),
            lambda x: torch.full((B,), x, dtype=torch.int32))
        np.testing.assert_allclose(got, want, **INT8_MODEL_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_chunked_equals_token_by_token_int8_bitwise():
    """Inside the port on the windowed mistral-7b smoke config: a chunked
    prefill writes the same int8 caches and scales and gives the same
    logits as token-by-token steps, bit for bit (reference backend, same
    ring geometry)."""
    cfg = get_smoke_config('mistral_7b')
    tm = Model(cfg)
    tp = tm.init(seed=2, device='cpu', dtype=torch.float32)
    B, S, T = 2, 24, 4
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)

    def states():
        return tm.make_states(B, S, torch.float32, chunk=T, device='cpu',
                              kv_quant=True)
    one, lg_one = states(), []
    for p in range(S):
        lg, one = tm.decode_step(tp, torch.from_numpy(toks[:, p:p + 1]), one,
                                 torch.full((B,), p, dtype=torch.int32),
                                 attn_backend='reference')
        lg_one.append(lg)
    ch, lg_ch = states(), []
    for p in range(0, S, T):
        lg, ch = tm.decode_step(tp, torch.from_numpy(toks[:, p:p + T]), ch,
                                torch.full((B,), p, dtype=torch.int32),
                                n_valid=torch.full((B,), T,
                                                   dtype=torch.int32),
                                attn_backend='reference')
        lg_ch.append(lg)
    assert torch.equal(torch.cat(lg_ch, dim=1), torch.cat(lg_one, dim=1))
    for part in ('layer0', 'body'):
        a = ch[part] if part == 'layer0' else ch[part][0]
        b = one[part] if part == 'layer0' else one[part][0]
        assert sorted(a) == sorted(LEAVES)
        for nm in LEAVES:
            assert torch.equal(a[nm], b[nm]), (part, nm)


# ------------------------------------------------------------------ engine
@pytest.fixture(scope='module')
def models():
    memo = {}

    def get(arch):
        if arch not in memo:
            jm = JaxModel(jax_smoke_config(arch))
            jp = jm.init(jax.random.PRNGKey(0))
            tm = Model(get_smoke_config(arch))
            tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
            memo[arch] = (jm, jp, tm, tp)
        return memo[arch]
    return get


def _serve(eng, req_cls, prompts, new_tokens=6):
    reqs = [req_cls(uid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


def _dense_prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 503, size=n).astype(np.int32)
            for n in (5, 12, 3, 9)]


def _shared_prompts(seed=1):
    """A 24-token shared prefix (3 pages); distinct tails, one a head of
    another's and one prompt equal to the prefix: both stop short inside
    a cached page (copy-on-write)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, 503, 24).astype(np.int32)
    tails = [rng.integers(3, 503, n).astype(np.int32) for n in (13, 5, 9)]
    prompts = [np.concatenate([prefix, t]) for t in tails]
    prompts += [np.concatenate([prefix, tails[0][:4]]), prefix.copy(),
                np.concatenate([prefix, tails[2][:2], [7, 7, 7]])]
    return prompts


@pytest.fixture(scope='module')
def jax_engine_runs(models):
    """JAX int8 engine results per (arch, chunk, paged, num_pages)."""
    memo = {}

    def get(arch, chunk, paged, num_pages=None):
        key = (arch, chunk, paged, num_pages)
        if key not in memo:
            jm, jp, _, _ = models(arch)
            if paged:
                eng = JaxEngine(jm, jp, max_slots=2, max_seq=MAX_SEQ,
                                chunk_size=chunk, prefix_cache=True,
                                page_size=PS, num_pages=num_pages,
                                kv_quant=True, attn_backend='reference')
                reqs = _serve(eng, JaxRequest, _shared_prompts())
            else:
                eng = JaxEngine(jm, jp, max_slots=3, max_seq=32,
                                chunk_size=chunk,
                                precomputed=jm.build_table(jp),
                                fused_gather_rope=chunk > 1, kv_quant=True,
                                attn_backend='reference')
                reqs = _serve(eng, JaxRequest, _dense_prompts())
            memo[key] = ([r.generated for r in reqs],
                         [r.prefix_hit_tokens for r in reqs],
                         eng.stats(reqs))
        return memo[key]
    return get


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
@pytest.mark.parametrize('chunk', [1, 4])
def test_dense_engine_int8_matches_jax(models, jax_engine_runs, chunk,
                                       backend):
    """mistral-7b smoke config on int8 dense ring caches, the table (and
    at chunk 4 the fused gather→RoPE), more requests than slots: greedy
    tokens equal the JAX engine's with kv_quant=True."""
    _, _, tm, tp = models('mistral_7b')
    tokens, _, _ = jax_engine_runs('mistral_7b', chunk, False)
    eng = ServingEngine(tm, tp, max_slots=3, max_seq=32, chunk_size=chunk,
                        precomputed=tm.build_table(tp),
                        fused_gather_rope=chunk > 1, kv_quant=True,
                        attn_backend=backend, device='cpu')
    assert eng.states['layer0']['k'].dtype == torch.int8
    reqs = _serve(eng, Request, _dense_prompts())
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert [r.generated for r in reqs] == tokens


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
@pytest.mark.parametrize('num_pages', [None, 9])
def test_paged_engine_int8_matches_jax(models, jax_engine_runs, num_pages,
                                       backend):
    """glm4-9b smoke config through the int8 pool: tokens, per-request
    prefix hits (copy-on-write included) and, with 9 pages, the
    preemption count equal the JAX int8 engine's; the pressured run's
    tokens equal the unpressured one's."""
    _, _, tm, tp = models('glm4_9b')
    tokens, hits, jstats = jax_engine_runs('glm4_9b', 4, True, num_pages)
    eng = ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ, chunk_size=4,
                        prefix_cache=True, page_size=PS, num_pages=num_pages,
                        kv_quant=True, attn_backend=backend, device='cpu')
    assert all(sorted(pool) == sorted(LEAVES) for pool, _ in eng._pools)
    reqs = _serve(eng, Request, _shared_prompts())
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert [r.generated for r in reqs] == tokens
    assert [r.prefix_hit_tokens for r in reqs] == hits
    stats = eng.stats(reqs)
    for key in ('prefix_hits', 'prefix_hit_tokens', 'pages_in_use',
                'preemptions'):
        assert stats[key] == jstats[key], key
    assert stats['cow_copies'] >= 2
    if num_pages:
        assert stats['preemptions'] > 0
        assert tokens == jax_engine_runs('glm4_9b', 4, True)[0]


def test_paged_int8_equals_dense_int8_and_pools_match(models):
    """Inside the port: the paged int8 engine's tokens are the dense int8
    engine's, cold and on prefix hits; the pools after the kernel write
    path (plain versions here) equal the plain scatters' bit for bit on
    all five leaves."""
    _, _, tm, tp = models('glm4_9b')
    table = tm.build_table(tp)
    out, engs = {}, {}
    for label, kw in (('dense', {}),
                      ('reference', dict(prefix_cache=True, page_size=PS,
                                         num_pages=12,
                                         attn_backend='reference')),
                      ('cuda', dict(prefix_cache=True, page_size=PS,
                                    num_pages=12, attn_backend='cuda'))):
        eng = ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ,
                            chunk_size=4, precomputed=table,
                            fused_gather_rope=True, kv_quant=True,
                            device='cpu', **kw)
        reqs = _serve(eng, Request, _shared_prompts(2), 8)
        out[label] = [r.generated for r in reqs]
        engs[label] = eng
    assert out['reference'] == out['dense'] == out['cuda']
    assert engs['cuda'].cow_copies > 0 and engs['cuda']._pending_clear == []
    for (ca, _), (cb, _) in zip(engs['reference']._pools,
                                engs['cuda']._pools):
        for nm in LEAVES:
            assert torch.equal(ca[nm], cb[nm]), nm


@pytest.mark.parametrize('paged', [False, True])
def test_mla_ignores_kv_quant(models, paged):
    """deepseek-v2-lite-16b: kv_quant=True builds the same latent caches
    (no int8, no scales) and gives the same tokens as without it."""
    _, _, tm, tp = models('deepseek_v2_lite_16b')
    kw = dict(prefix_cache=True, page_size=PS) if paged else {}
    out = {}
    for quant in (False, True):
        eng = ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ,
                            chunk_size=4, kv_quant=quant, device='cpu', **kw)
        assert sorted(eng.states['layer0']) == ['ckv', 'kpe', 'pos']
        out[quant] = [r.generated for r in
                      _serve(eng, Request, _shared_prompts(3), 4)]
    assert out[True] == out[False]
