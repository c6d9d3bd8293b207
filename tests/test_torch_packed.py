"""Segment-packed prefill (``ServingEngine(pack_prefill=True)``) of the
port against its own unpacked chunked engine and against the JAX package's
packed engine, on the same numpy weights.

- ``_pack_layout`` equals JAX's ``ServingEngine._pack_layout`` exactly
  (packed tokens, ``seg_row`` / ``seg_off`` and the four lane arrays) on
  seeded random ``n_valid`` vectors; ``PackedLayout.to_slots`` /
  ``to_lanes`` equal JAX's gathers.
- Packed is bitwise unpacked, greedy tokens and ``score()`` logits, on the
  smoke configs (fp32, 4 slots, chunk 4, page 8, the table with the fused
  gather-RoPE): mistral-7b on dense ring caches and on ring pages (a
  snapshot hit), glm4-9b paged in fp32 and int8 (a prefix hit and a
  copy-on-write), deepseek-v2-lite-16b (MLA + MoE) at a capacity factor of
  0.5, where experts drop tokens (the drop count is equal too), and
  pythia-6.9b (the parallel block) dense and paged; packing raises
  ``prefill_lane_utilization``.
- Each family's packed engine against JAX's packed engine
  (``attn_backend='reference'``, fp32, the first wave and the scoring):
  greedy tokens equal, ``score()`` logits within ROADMAP's tolerance (atol
  2e-4, rtol 2e-3), lane counts and MoE drops equal. int8 engines are held
  to JAX's by ``tests/test_torch_quant.py``; here int8 packed is held
  bitwise to the port's own unpacked int8 engine.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.attention import PackedLayout as JaxPackedLayout
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models.attention import PackedLayout
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.programs import PACKED

PS = 8
MAX_SEQ = 64
NEW = 5
ARCH = {'mistral': 'mistral_7b', 'glm4': 'glm4_9b',
        'deepseek': 'deepseek_v2_lite_16b', 'pythia': 'pythia_6_9b'}
# the engines of each family's bitwise case: (paged, kv_quant)
VARIANTS = {'mistral': [(False, False), (True, False)],
            'glm4': [(True, False), (True, True)],
            'deepseek': [(True, False), (False, False)],
            'pythia': [(False, False), (True, False)]}
# each family's engine against JAX's packed engine
JAX_CASE = {'mistral': (True, False), 'glm4': (True, False),
            'deepseek': (True, False), 'pythia': (False, False)}
LENS = (3, 9, 17, 5, 12)
TOL = dict(atol=2e-4, rtol=2e-3)


def _cfg(kind, get):
    cfg = get(ARCH[kind])
    if kind == 'deepseek':       # experts drop tokens at this capacity
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    return cfg


@pytest.fixture(scope='module')
def models():
    memo = {}

    def get(kind):
        if kind not in memo:
            jm = JaxModel(_cfg(kind, jax_smoke_config))
            jp = jm.init(jax.random.PRNGKey(0))
            tm = Model(_cfg(kind, get_smoke_config))
            tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
            memo[kind] = (jm, jp, tm, tp)
        return memo[kind]
    return get


def _waves(vocab):
    """Wave 1: five prompts of LENS tokens (more than the 4 slots). Wave 2:
    the 17-token prompt again (a prefix or snapshot hit when paged) and the
    12-token prompt's first 11 tokens (it stops inside a cached page)."""
    rng = np.random.default_rng(3)
    first = [rng.integers(3, vocab, n).astype(np.int32) for n in LENS]
    return [first, [first[2].copy(), first[4][:11].copy()]]


def _serve(eng, req_cls, n_waves=2):
    """The first ``n_waves`` waves, then ``score()`` of two prompts. ->
    (greedy tokens, score logits, stats)."""
    reqs = []
    waves = _waves(eng.model.cfg.vocab_size)
    for w, prompts in enumerate(waves[:n_waves]):
        wave = [req_cls(uid=10 * w + i, prompt=p, max_new_tokens=NEW)
                for i, p in enumerate(prompts)]
        for r in wave:
            eng.submit(r)
        eng.run()
        reqs += wave
    assert all(r.status.name == 'FINISHED' for r in reqs), \
        [(r.uid, r.status, r.error) for r in reqs]
    scores = eng.score([waves[0][1], waves[0][3]])
    return [list(r.generated) for r in reqs], scores, eng.stats(reqs)


def _engine(cls, model, params, paged, kv_quant, **kw):
    if paged:
        kw.update(prefix_cache=True, page_size=PS)
    return cls(model, params, max_slots=4, max_seq=MAX_SEQ, chunk_size=4,
               precomputed=model.build_table(params), fused_gather_rope=True,
               kv_quant=kv_quant, **kw)


# ------------------------------------------------------------------ layout
def test_pack_layout_matches_jax():
    """First-fit decreasing, R a power of two capped at the bucket's
    width: every array equal to JAX's, on 60 seeded ``n_valid`` vectors
    (zeros, singletons, full rows) over buckets of 4, 8 and 16 slots."""
    rng = np.random.default_rng(0)
    for S, T in ((4, 4), (8, 8), (16, 4), (8, 16)):
        for _ in range(15):
            n_valid = rng.integers(0, T + 1, S).astype(np.int32)
            n_valid[rng.integers(0, S)] = rng.integers(1, T + 1)
            tokens = rng.integers(3, 200, (S, T)).astype(np.int32)
            host = types.SimpleNamespace(
                slot_pos=rng.integers(0, 40, S).astype(np.int64))
            got = ServingEngine._pack_layout(host, tokens, n_valid)
            want = JaxEngine._pack_layout(host, tokens, n_valid)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_array_equal(got[3], want[3])
            for nm, arr in got[1].items():
                np.testing.assert_array_equal(
                    arr, np.asarray(getattr(want[1], nm)).astype(np.int32),
                    err_msg=nm)
            R = got[0].shape[0]
            assert R <= S and R & (R - 1) == 0


def test_packed_layout_gathers_match_jax():
    """``to_slots`` (packed (R, T, d) -> slot-major (S, T, d), clipped
    reads past a segment) and ``to_lanes`` (back) equal JAX's."""
    rng = np.random.default_rng(1)
    S, T, d = 8, 4, 3
    n_valid = np.array([4, 1, 0, 3, 2, 1, 4, 0], np.int32)
    host = types.SimpleNamespace(slot_pos=np.arange(S) * 5)
    _, layout, _, _ = ServingEngine._pack_layout(
        host, np.zeros((S, T), np.int32), n_valid)
    torch_layout = PackedLayout(*(torch.from_numpy(layout[nm]) for nm in (
        'seg_row', 'seg_off', 'lane_slot', 'lane_local', 'lane_pos')),
        torch.from_numpy(layout['lane_valid']).bool())
    jax_layout = JaxPackedLayout(*(jnp.asarray(layout[nm]) for nm in (
        'seg_row', 'seg_off', 'lane_slot', 'lane_local', 'lane_pos')),
        jnp.asarray(layout['lane_valid'].astype(bool)))
    R = layout['lane_slot'].shape[0]
    x = rng.standard_normal((R, T, d)).astype(np.float32)
    y = rng.standard_normal((S, T, d)).astype(np.float32)
    np.testing.assert_array_equal(
        torch_layout.to_slots(torch.from_numpy(x)).numpy(),
        np.asarray(jax_layout.to_slots(jnp.asarray(x))))
    np.testing.assert_array_equal(
        torch_layout.to_lanes(torch.from_numpy(y)).numpy(),
        np.asarray(jax_layout.to_lanes(jnp.asarray(y))))


# ---------------------------------------------------------------- engines
@pytest.mark.parametrize('kind', list(ARCH))
def test_packed_bitwise_unpacked(models, kind):
    """For each engine of the family: greedy tokens and ``score()``
    logits of the packed engine bitwise those of the unpacked one (the
    ``cuda`` backend's plain versions on the CPU: fused page writes and
    deferred clears); packed steps ran (their program keys), and the lane
    utilization rose. deepseek: MoE drops happened and are equal."""
    _, _, tm, tp = models(kind)
    for paged, kv_quant in VARIANTS[kind]:
        out = {}
        for pack in (False, True):
            eng = _engine(ServingEngine, tm, tp, paged, kv_quant,
                          pack_prefill=pack, attn_backend='cuda',
                          device='cpu')
            out[pack] = _serve(eng, Request)
            assert any(k[0] == PACKED for k in eng.programs) == pack
        (tok0, sc0, st0), (tok1, sc1, st1) = out[False], out[True]
        assert tok1 == tok0, (paged, kv_quant)
        assert [x.tobytes() for x in sc1] == [x.tobytes() for x in sc0]
        assert st1['lane_tokens'] == st0['lane_tokens']
        assert st1['prefill_lane_utilization'] \
            > st0['prefill_lane_utilization'], (st0, st1)
        assert st1['moe_token_drops'] == st0['moe_token_drops']
        if kind == 'deepseek':
            assert st0['moe_token_drops'] > 0
        if paged:
            assert st1['prefix_hits'] == st0['prefix_hits'] > 0


@pytest.fixture(scope='module')
def jax_packed(models):
    memo = {}

    def get(kind):
        if kind not in memo:
            jm, jp, _, _ = models(kind)
            paged, kv_quant = JAX_CASE[kind]
            eng = _engine(JaxEngine, jm, jp, paged, kv_quant,
                          pack_prefill=True, attn_backend='reference')
            assert eng.pack_prefill
            memo[kind] = _serve(eng, JaxRequest, n_waves=1)
        return memo[kind]
    return get


@pytest.mark.parametrize('kind', list(ARCH))
def test_packed_matches_jax_packed(models, jax_packed, kind):
    """The family's packed engine against JAX's packed engine on the same
    weights and traffic: greedy tokens equal, score logits within the
    tolerance, the same lanes dispatched and carrying tokens, and the same
    MoE drops."""
    jtok, jsc, jst = jax_packed(kind)
    _, _, tm, tp = models(kind)
    paged, kv_quant = JAX_CASE[kind]
    eng = _engine(ServingEngine, tm, tp, paged, kv_quant, pack_prefill=True,
                  attn_backend='reference', device='cpu')
    tok, sc, st = _serve(eng, Request, n_waves=1)
    assert tok == jtok
    for got, want in zip(sc, jsc):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for key in ('lanes_dispatched', 'lane_tokens', 'moe_token_drops'):
        assert st[key] == jst[key], (key, st[key], jst[key])
