"""Token ids outside the vocabulary (ROADMAP C1): the port reads rows with
``jnp.take``'s semantics, as the JAX package does, so such an id fails only
its own request.

- Rows: ``layers.embed_lookup``, ``embed_gather_plain`` and
  ``gather_rope_plain`` against ``jnp.take`` (and JAX's
  ``ref.gather_rope_ref``): ids in [-V, 0) wrap, ids outside [-V, V) give
  rows of NaN; NaN compared as equal to NaN. The JAX Pallas gather-RoPE
  kernel clamps such ids instead (the port follows ``jnp.take`` on its
  fused path too: ROADMAP C2), held here as the probe of that difference.
- Engines: the port's engine (both attention backends) against the JAX
  engine on each request's status, error and greedy tokens: dense
  mistral-7b and paged glm4-9b smoke configs, fp32 and int8 KV, without
  the table, with it, and with the fused gather-RoPE; deepseek-v2-lite
  paged with the table and the fused gather-RoPE. The JAX engine runs
  unfused (its fused kernel clamps). The out-of-vocabulary request FAILS
  with ``nonfinite_logits``, an id of -1 FINISHES.
- A clean request after a failed one, in the slot (and on the pages) it
  left, gets a fresh engine's tokens.

The ``cuda``-marked twins (kernels and engine on the card) are in
``tests/test_torch_kernels.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.embed_gather import embed_gather, embed_gather_plain
from repro_torch.kernels.gather_rope import gather_rope, gather_rope_plain
from repro_torch.models.layers import embed_lookup
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, ServingEngine

from _torch_scenarios import clean_after_failed, oov_prompts, serve_outcomes

V = 503                                   # every smoke config's vocabulary
IDS = np.array([3, -1, -V, -V - 1, V, V + 7, 0, V - 1, 2 ** 31 - 1, -2 ** 31],
               np.int32)
FINISHED = ('FINISHED', None)


def _assert_rows(got, want):
    """Equal where finite, NaN where NaN (bitwise for finite rows)."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


# ---------------------------------------------------------------- rows
# (Each test below loops over its cases rather than parametrising them:
# ROADMAP C4 keeps the suite under 888 collected tests.)
DTYPES = ('float32', 'bfloat16')


def test_row_reads_follow_jnp_take():
    tab = np.random.default_rng(0).standard_normal((V, 96)) \
        .astype(np.float32)
    ids = torch.from_numpy(IDS)
    for dtype in DTYPES:
        jt = jnp.asarray(tab).astype(dtype)
        tt = torch.from_numpy(tab).to(getattr(torch, dtype))
        want = np.asarray(jnp.take(jt, jnp.asarray(IDS), axis=0)
                          .astype(jnp.float32))
        for got in (embed_lookup({'table': tt}, ids),
                    embed_gather_plain(tt, ids), embed_gather(tt, ids)):
            assert got.dtype == tt.dtype
            _assert_rows(got.float().numpy(), want)
        assert np.isnan(want[[3, 4, 5, 8, 9]]).all()
        assert not np.isnan(want[[0, 1, 2, 6, 7]]).any()


def test_gather_rope_plain_follows_jnp_take():
    """Against JAX's oracle ``ref.gather_rope_ref`` (``jnp.take``, then
    the rotation), fp32 and bf16: a NaN row rotated is NaN; wrapped rows
    are rotated as their own rows."""
    tab = np.random.default_rng(1).standard_normal((V, 96)) \
        .astype(np.float32)
    pos = np.arange(len(IDS), dtype=np.int32) * 37
    segs = ((16, 2, 16), (64, 1, 16))
    for dtype, tol in zip(DTYPES, (1e-5, 1e-2)):
        want = np.asarray(JREF.gather_rope_ref(
            jnp.asarray(tab).astype(dtype), jnp.asarray(IDS),
            jnp.asarray(pos), segs=segs, theta=1e4).astype(jnp.float32))
        tt = torch.from_numpy(tab).to(getattr(torch, dtype))
        args = (tt, torch.from_numpy(IDS), torch.from_numpy(pos))
        for got in (gather_rope_plain(*args, segs=segs, theta=1e4),
                    gather_rope(*args, segs=segs, theta=1e4)):
            got = got.float().numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(np.nan_to_num(got),
                                       np.nan_to_num(want), atol=tol,
                                       rtol=tol)


def test_fused_read_differs_from_jax_pallas_kernel_by_design():
    """ROADMAP C2's probe: JAX's Pallas gather-RoPE kernel (interpret
    mode) clamps an id of V to row V - 1 and finishes such a request on its
    fused path; the port's fused read gives NaN, as ``jnp.take``."""
    tab = np.random.default_rng(2).standard_normal((8, 64)) \
        .astype(np.float32)
    ids, pos = np.array([9, 7], np.int32), np.array([5, 5], np.int32)
    kw = dict(q_off=0, num_heads=2, k_off=32, num_kv_heads=1, head_dim=16,
              theta=1e4)
    jrows = np.asarray(JOPS.gather_rope_rows(
        jnp.asarray(tab), jnp.asarray(ids), jnp.asarray(pos), **kw))
    np.testing.assert_array_equal(jrows[0], jrows[1])      # clamped to 7
    got = gather_rope(torch.from_numpy(tab), torch.from_numpy(ids),
                      torch.from_numpy(pos),
                      segs=((0, 2, 16), (32, 1, 16)), theta=1e4).numpy()
    assert np.isnan(got[0]).all()
    np.testing.assert_allclose(got[1], jrows[1], atol=1e-5, rtol=1e-5)


# -------------------------------------------------------------- engines
@pytest.fixture(scope='module')
def models():
    """(JAX model, params, table) and (port model, params, table) per
    smoke arch, made once."""
    memo = {}

    def get(arch):
        if arch not in memo:
            jm = JaxModel(jax_smoke_config(arch))
            jp = jm.init(jax.random.PRNGKey(0))
            tm = Model(get_smoke_config(arch))
            tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
            memo[arch] = (jm, jp, jm.build_table(jp)), \
                (tm, tp, tm.build_table(tp))
        return memo[arch]
    return get


def _engine_kw(paged, kv_quant):
    kw = dict(max_slots=2, max_seq=32, chunk_size=4, kv_quant=kv_quant)
    if paged:
        kw.update(prefix_cache=True, page_size=4)
    return kw


# (arch, paged, kv_quant, table read(s) of the port's runs)
CASES = [(arch, paged, kv_quant, reads)
         for arch, paged in (('mistral_7b', False), ('glm4_9b', True))
         for kv_quant in (False, True)
         for reads in (('none',), ('gather', 'fused'))] \
    + [('deepseek_v2_lite_16b', True, False, ('fused',))]


@pytest.fixture(scope='module')
def jax_outcomes(models):
    """The JAX engine's outcomes per (arch, paged, kv_quant, table?),
    unfused, reference backend."""
    memo = {}

    def get(arch, paged, kv_quant, table):
        key = (arch, paged, kv_quant, table)
        if key not in memo:
            (jm, jp, jt), _ = models(arch)
            eng = JaxEngine(jm, jp, precomputed=jt if table else None,
                            attn_backend='reference',
                            **_engine_kw(paged, kv_quant))
            memo[key] = serve_outcomes(eng, JaxRequest, oov_prompts(V))
        return memo[key]
    return get


@pytest.mark.parametrize('arch,paged,kv_quant,reads', CASES, ids=[
    f'{a}-{"paged" if p else "dense"}-{"int8" if q else "fp32"}-'
    f'{"+".join(r)}' for a, p, q, r in CASES])
def test_out_of_vocab_fails_only_its_request(models, jax_outcomes, arch,
                                             paged, kv_quant, reads):
    """Each table read (none: the embedding; the table's gather; the fused
    gather-RoPE) and attention backend against the JAX engine."""
    want = jax_outcomes(arch, paged, kv_quant, reads != ('none',))
    assert want[0][:2] == ('FAILED', 'nonfinite_logits')
    assert [w[:2] for w in want[1:]] == [FINISHED] * 3
    _, (tm, tp, tt) = models(arch)
    for read in reads:
        for backend in ('reference', 'cuda'):
            eng = ServingEngine(tm, tp, precomputed=None if read == 'none'
                                else tt, fused_gather_rope=read == 'fused',
                                attn_backend=backend, device='cpu',
                                **_engine_kw(paged, kv_quant))
            assert eng.fused_gather_rope == (read == 'fused')
            got = serve_outcomes(eng, Request, oov_prompts(V))
            assert got == want, (read, backend)


@pytest.mark.parametrize('paged', [False, True])
def test_clean_request_after_failed_one_gets_fresh_tokens(models, paged):
    """One slot (glm4-9b smoke, the table's fused read, fp32 and int8 KV):
    the clean request runs in the slot the failed one left and, paged, on
    pages it freed; its tokens are a fresh engine's and the JAX
    engine's."""
    (jm, jp, jt), (tm, tp, tt) = models('glm4_9b')
    for kv_quant in (False, True):
        kw = dict(_engine_kw(paged, kv_quant), max_slots=1)
        if paged:
            kw['num_pages'] = 9

        def engine():
            return ServingEngine(tm, tp, precomputed=tt,
                                 fused_gather_rope=True, attn_backend='cuda',
                                 device='cpu', **kw)
        after, fresh, pages = clean_after_failed(engine, V)
        assert after[0][:2] == ('FAILED', 'nonfinite_logits')
        assert after[1] == fresh[0] and fresh[0][:2] == FINISHED
        if paged:
            assert pages[0] & pages[1], pages    # pages the failed one freed
        want = serve_outcomes(JaxEngine(jm, jp, precomputed=jt,
                                        attn_backend='reference', **kw),
                              JaxRequest, [oov_prompts(V)[3]])
        assert fresh == want, kv_quant
