"""Slot buckets, the fixed-width deferred-clear array and the per-step
programs of the port's ``ServingEngine`` against the JAX package's engine,
on the same numpy weights.

- ``_bucket`` equals JAX's ``ServingEngine._bucket`` (smallest power of
  two, floor 8, covering the highest active slot, capped at
  ``max_slots``; full width up to 8 slots).
- A 32-slot engine serving 3 requests dispatches 8-wide steps (a spy on
  ``Model.decode_step``) and gives the 4-slot engine's greedy tokens
  bitwise, and JAX's 32-slot engine's tokens and ``stats()`` (lane counts
  and pool counters included): dense chunked mistral-7b, paged glm4-9b,
  paged mistral-7b on ring pages, paged deepseek-v2-lite-16b (MLA, MoE).
  The port runs its ``cuda`` backend, whose kernels run their plain
  versions on the CPU: the fused page writes through the padded pending
  array and job lists that a CUDA graph replays on the card.
- More than ``_pending_cap`` (64) pages allocated in one tick flush
  eagerly; the pools then equal JAX's engine's (position leaves bitwise,
  K/V within the cross-framework tolerance).
- The program cache holds one program per step shape after a run that
  mixes prefill, decode and ``score()``; programs reused across steps
  with other ``n_valid``, pending arrays and temperatures give the tokens
  of an engine that runs every step eagerly on fresh programs.

The ``cuda`` twin of the replay-against-eager check is
``tests/test_torch_kernels.py::test_programs_replay_matches_eager_on_card``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving import Request, RequestStatus, ServingEngine
from repro_torch.serving.engine import _eager_steps
from repro_torch.serving.programs import CHUNK, STEP

from _torch_scenarios import replay_vs_eager_run

PS = 8
MAX_SEQ = 64
CHUNK_SIZE = 4
NEW = 4
ARCH = {'glm4': 'glm4_9b', 'mistral': 'mistral_7b',
        'deepseek': 'deepseek_v2_lite_16b'}
# (model, paged?) of each wide-engine case
WIDE = {'mistral-dense': ('mistral', False), 'glm4-paged': ('glm4', True),
        'mistral-ring': ('mistral', True), 'deepseek-mla': ('deepseek', True)}
STAT_KEYS = ('completed', 'tokens', 'engine_steps', 'moe_token_drops',
             'lanes_dispatched', 'lane_tokens', 'preemptions', 'failed')
POOL_KEYS = ('prefix_hits', 'prefix_misses', 'prefix_hit_tokens',
             'pages_in_use', 'pages_free', 'evictions')


@pytest.fixture(scope='module')
def models():
    memo = {}

    def get(kind):
        if kind not in memo:
            jm = JaxModel(jax_smoke_config(ARCH[kind]))
            jp = jm.init(jax.random.PRNGKey(0))
            tm = Model(get_smoke_config(ARCH[kind]))
            tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
            memo[kind] = (jm, jp, tm, tp)
        return memo[kind]
    return get


def _prompts(vocab, sizes=(11, 17, 9), seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in sizes]


def _engine(cls, model, params, paged, **kw):
    if paged:
        kw.setdefault('page_size', PS)
        kw['prefix_cache'] = True
    kw.setdefault('chunk_size', CHUNK_SIZE)
    return cls(model, params, max_seq=MAX_SEQ, **kw)


def _serve(eng, req_cls, prompts, **kw):
    reqs = [req_cls(uid=i, prompt=p, max_new_tokens=NEW, **kw)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.status.name == 'FINISHED' for r in reqs), \
        [(r.uid, r.status, r.error) for r in reqs]
    return reqs


def _outcome(eng, reqs):
    stats = eng.stats(reqs)
    keys = STAT_KEYS + (POOL_KEYS if eng.kv is not None else ())
    return [list(r.generated) for r in reqs], {k: stats[k] for k in keys}


# ------------------------------------------------------------------ buckets
def test_bucket_matches_jax():
    actives = [[0], [2], [7], [0, 7], [8], [0, 9], [3, 15], [16], [31],
               [0, 1, 2], [40], [63, 1], [64], [100], [255], [5, 200]]
    for S in (4, 8, 9, 32, 256):
        eng = types.SimpleNamespace(max_slots=S)
        for active in actives + [[]]:
            active = [s for s in active if s < S]
            got = ServingEngine._bucket(eng, active)
            assert got == JaxEngine._bucket(eng, active), (S, active)
            assert got == S or (got >= 8 and got & (got - 1) == 0
                                and got > max(active, default=-1))


# -------------------------------------------------------------- wide engine
@pytest.fixture(scope='module')
def jax_wide(models):
    memo = {}

    def get(case):
        if case not in memo:
            kind, paged = WIDE[case]
            jm, jp, _, _ = models(kind)
            eng = _engine(JaxEngine, jm, jp, paged, max_slots=32,
                          attn_backend='reference')
            memo[case] = _outcome(eng, _serve(
                eng, JaxRequest, _prompts(jm.cfg.vocab_size)))
        return memo[case]
    return get


@pytest.mark.parametrize('case', list(WIDE))
def test_wide_engine_matches_narrow_and_jax(models, jax_wide, monkeypatch,
                                            case):
    """32 slots, 3 requests: every dispatch is 8 slots wide; greedy tokens
    bitwise the 4-slot engine's; tokens and ``stats()`` equal JAX's 32-slot
    engine's (``lanes_dispatched`` counts the bucket's lanes)."""
    kind, paged = WIDE[case]
    _, _, tm, tp = models(kind)
    prompts = _prompts(tm.cfg.vocab_size)
    widths = []
    step = tm.decode_step

    def spy(params, tokens, states, *args, **kw):
        widths.append(tokens.shape[0])
        return step(params, tokens, states, *args, **kw)
    monkeypatch.setattr(tm, 'decode_step', spy)
    out = {}
    for slots in (32, 4):
        eng = _engine(ServingEngine, tm, tp, paged, max_slots=slots,
                      attn_backend='cuda', device='cpu')
        assert eng._fused_maint == paged and not eng._graphs
        out[slots] = _outcome(eng, _serve(eng, Request, prompts))
        if slots == 32:
            assert widths and set(widths) == {8}, sorted(set(widths))
            assert {k[1] for k in eng.programs} == {8}
    want_tokens, want_stats = jax_wide(case)
    assert out[32][0] == want_tokens
    assert out[4][0] == want_tokens
    assert out[32][1] == want_stats


# ----------------------------------------------------------- pending array
def test_pending_overflow_flushes_eagerly(models, monkeypatch):
    """Page size 1 and chunk 32: the first dispatch of 3 prompts allocates
    96 pages, so past 64 deferred clears the engine clears them eagerly
    and the step takes the rest as the zero-padded 64-wide array. Tokens
    and pools then equal JAX's engine's."""
    jm, jp, tm, tp = models('glm4')
    prompts = _prompts(tm.cfg.vocab_size, sizes=(40, 37, 45), seed=9)
    kw = dict(max_slots=3, page_size=1, chunk_size=32)
    jeng = _engine(JaxEngine, jm, jp, True, attn_backend='reference', **kw)
    jreqs = _serve(jeng, JaxRequest, prompts)
    eng = _engine(ServingEngine, tm, tp, True, attn_backend='cuda',
                  device='cpu', **kw)
    flushed, staged = [], []
    flush, stage = eng._flush_pending, eng._paged_host

    def spy_flush():
        flushed.append(len(eng._pending_clear))
        flush()

    def spy_stage(*args):
        out = stage(*args)
        staged.append(int((out['pending'] > 0).sum()))
        assert out['pending'].shape == (64,)
        return out
    monkeypatch.setattr(eng, '_flush_pending', spy_flush)
    monkeypatch.setattr(eng, '_paged_host', spy_stage)
    reqs = _serve(eng, Request, prompts)
    assert eng._pending_cap == 64 and flushed and flushed[0] == 65, flushed
    assert staged[0] == 96 - 65, staged
    assert [r.generated for r in reqs] == [list(r.generated) for r in jreqs]
    for part, jst in jeng.states.items():
        for layer, jlayer in zip(*[s if isinstance(s, list) else [s]
                                   for s in (eng.states[part], jst)]):
            assert sorted(layer) == sorted(jlayer)
            for nm, leaf in layer.items():
                want = np.asarray(jlayer[nm])
                if nm == 'pos':
                    np.testing.assert_array_equal(leaf.numpy(), want)
                else:
                    np.testing.assert_allclose(leaf.numpy(), want,
                                               atol=2e-4, rtol=2e-3)


# ----------------------------------------------------------------- programs
def test_program_cache_holds_one_program_per_step_shape(models):
    """Dense chunked mistral-7b, 4 slots: prefill chunks, one-token decode
    steps, then ``score()`` of a 5-token prompt (a logits chunk, then the
    one-token step with logits). Each program keeps its buffers across its
    steps; on the CPU nothing is captured."""
    _, _, tm, tp = models('mistral')
    eng = _engine(ServingEngine, tm, tp, False, max_slots=4, device='cpu')
    _serve(eng, Request, _prompts(tm.cfg.vocab_size))
    bufs = {k: p.buf.data_ptr() for k, p in eng.programs.items()}
    assert set(eng.programs) == {(CHUNK, 4, CHUNK_SIZE, False),
                                 (STEP, 4, 1, False)}
    eng.score([_prompts(tm.cfg.vocab_size, sizes=(5,))[0]])
    assert set(eng.programs) == {(CHUNK, 4, CHUNK_SIZE, False),
                                 (STEP, 4, 1, False),
                                 (CHUNK, 4, CHUNK_SIZE, True),
                                 (STEP, 4, 1, True)}
    assert all(eng.programs[k].buf.data_ptr() == v for k, v in bufs.items())
    assert all(p.graph is None and p.replays == 0
               for p in eng.programs.values())


@pytest.mark.parametrize('kind', ['glm4', 'mistral'])
def test_program_reuse_matches_fresh_eager_programs(models, monkeypatch,
                                                    kind):
    """Paged glm4-9b and ring-paged mistral-7b, ``cuda`` backend on the CPU,
    temperatures 0, 0.7 and 1.3: one engine reuses each step shape's
    program across steps whose ``n_valid``, pending arrays and
    temperatures differ; another runs inside ``_eager_steps()`` and drops
    its programs before every step, so each step stages into new buffers.
    Greedy and sampled tokens are equal."""
    _, _, tm, tp = models(kind)
    prompts = _prompts(tm.cfg.vocab_size, sizes=(11, 17, 9, 14), seed=3)
    temps = (0.0, 0.7, 1.3, 0.0)

    def run(fresh):
        eng = _engine(ServingEngine, tm, tp, True, max_slots=3, seed=1,
                      attn_backend='cuda', device='cpu')
        seen = []
        stage = eng._step_arrays

        def spy(*args):
            out = stage(*args)
            if fresh:
                eng.programs.clear()
            seen.append((tuple(out['n_valid']), int((out['pending'] > 0)
                                                    .sum()),
                         tuple(out['temps'])))
            return out
        monkeypatch.setattr(eng, '_step_arrays', spy)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6, temperature=t)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        for r in reqs:
            eng.submit(r)
        if fresh:
            with _eager_steps():
                eng.run()
        else:
            eng.run()
        assert all(r.status is RequestStatus.FINISHED for r in reqs)
        return [r.generated for r in reqs], seen, eng

    (want, _, _), (got, seen, eng) = run(True), run(False)
    assert got == want
    # programs were reused over differing inputs
    assert len(eng.programs) < len(seen)
    assert len({s[0] for s in seen}) > 2 and len({s[1] for s in seen}) > 1
    assert len({s[2] for s in seen}) > 1


def test_programs_replay_matches_eager_scenario_on_cpu():
    """The scenario of the ``cuda`` twin, on the CPU (no capture there):
    a 16-slot paged engine (bucket 8) gives the tokens, score logits and
    pools of the same engine inside ``_eager_steps()``."""
    got, want, info = replay_vs_eager_run('cpu')
    assert got == want
    assert info['buckets'] == {8} and info['graphs'] == 0
