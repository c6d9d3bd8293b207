"""The async double-buffered host loop (``ServingEngine(async_loop=True)``)
of the port against its own synchronous loop and against the JAX package's
synchronous engine, on the same numpy weights.

The contract, as in JAX: the host schedules and stages step N+1 before it
commits step N, and the device splices each decoding slot's previous token
in (``use_prev``). Host-visible request state trails the device by one
dispatch; ``run()`` and ``score()`` drain the pipeline. Greedy tokens are
bitwise the synchronous loop's.

- Async greedy tokens and ``score()`` logits bitwise sync, with and without
  packing, for the smoke configs (fp32, 4 slots, chunk 4, page 8, the
  ``cuda`` backend's plain versions on the CPU) of mistral-7b (dense ring
  caches, ring pages, int8 ring pages), glm4-9b (dense at chunk 1 and 4,
  paged, int8 paged), deepseek-v2-lite-16b (MLA + MoE, dense and paged) and
  pythia-6.9b (dense, paged, int8 dense).
- Async against JAX's synchronous engine: equal tokens, for glm4-9b dense
  at chunk 1 (a prefilling slot on the one-token path: JAX's own async loop
  feeds it a stale token there, ROADMAP C.2) and deepseek-v2-lite-16b
  paged with packing. JAX's async engine is not the oracle (ROADMAP C.3).
- Contract cases: an EOS lane dispatched speculatively and discarded;
  ``cancel(uid)`` and an expired deadline while the slot's step is in
  flight; page steals that preempt (async against sync); the flush at a
  ring snapshot boundary; the one-step lag and the drain; the
  ``engine.step.overlap_s`` histogram; ``mesh`` with ``async_loop``
  raising (ROADMAP A.3) while ``mesh`` with ``pack_prefill`` serves; the
  CLI's ``--async-loop``; the scenario of the ``cuda`` twin
  (``tests/test_torch_kernels.py::test_async_packed_replays_match_eager_on_card``).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import contextlib
import io
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving import (Request, RequestStatus, ScriptedFaults,
                                 ServingEngine)
from repro_torch.serving import telemetry as TM

from _torch_scenarios import async_packed_vs_eager_run

PS = 8
MAX_SEQ = 64
NEW = 5
ARCH = {'mistral': 'mistral_7b', 'glm4': 'glm4_9b',
        'deepseek': 'deepseek_v2_lite_16b', 'pythia': 'pythia_6_9b'}
# (paged, kv_quant, chunk) of each family's engines
VARIANTS = {'mistral': [(False, False, 4), (True, False, 4),
                        (True, True, 4)],
            'glm4': [(False, False, 1), (False, False, 4), (True, False, 4),
                     (True, True, 4)],
            'deepseek': [(False, False, 4), (True, False, 4)],
            'pythia': [(False, False, 4), (True, False, 4),
                       (False, True, 4)]}
LENS = (3, 9, 17, 5, 12)


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


def _prompts(vocab, lens=LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in lens]


def _engine(cls, model, params, paged=True, kv_quant=False, chunk=4, **kw):
    if paged:
        kw.update(prefix_cache=True, page_size=PS)
    kw.setdefault('max_slots', 4)
    return cls(model, params, max_seq=MAX_SEQ, chunk_size=chunk,
               kv_quant=kv_quant, **kw)


def _port(model, params, paged=True, kv_quant=False, chunk=4, **kw):
    return _engine(ServingEngine, model, params, paged, kv_quant, chunk,
                   attn_backend='cuda', device='cpu', **kw)


def _submit(eng, req_cls, prompts, uid0=0, **kw):
    reqs = [req_cls(uid=uid0 + i, prompt=p, max_new_tokens=NEW, **kw)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs


def _serve(eng, req_cls, prompts, **kw):
    reqs = _submit(eng, req_cls, prompts, **kw)
    eng.run()
    assert all(r.status.name == 'FINISHED' for r in reqs), \
        [(r.uid, r.status, r.error) for r in reqs]
    return [list(r.generated) for r in reqs]


def _no_leak(eng):
    """Every page is free or held by the radix index, once."""
    kv = eng.kv
    assert all(r is None for r in eng.slot_req) and eng._pending is None
    radix, stack = [], list(kv.root.children.values())
    while stack:
        node = stack.pop()
        radix.append(node.page)
        stack.extend(node.children.values())
    assert sorted(list(kv._free) + radix) == list(range(1, kv.num_pages))


# ------------------------------------------------------ async against sync
@pytest.mark.parametrize('kind', list(ARCH))
def test_async_bitwise_sync(models, kind):
    """Each engine of the family, unpacked and packed, with the table and
    the fused gather-RoPE: the async loop's greedy tokens and ``score()``
    logits are bitwise the synchronous loop's, and ``score()`` leaves
    nothing in flight."""
    _, _, tm, tp = models(kind)
    table = tm.build_table(tp)
    prompts = _prompts(tm.cfg.vocab_size)
    for paged, kv_quant, chunk in VARIANTS[kind]:
        for pack in (False, True):
            out = []
            for async_loop in (False, True):
                eng = _port(tm, tp, paged, kv_quant, chunk,
                            precomputed=table, fused_gather_rope=True,
                            pack_prefill=pack, async_loop=async_loop)
                tokens = _serve(eng, Request, prompts)
                logits = eng.score(prompts[1:3])
                assert eng._pending is None
                out.append((tokens, [x.tobytes() for x in logits]))
            assert out[1] == out[0], (paged, kv_quant, chunk, pack)


@pytest.fixture(scope='module')
def jax_sync(models):
    memo = {}

    def get(kind, paged, chunk):
        key = (kind, paged, chunk)
        if key not in memo:
            jm, jp, _, _ = models(kind)
            eng = _engine(JaxEngine, jm, jp, paged, chunk=chunk,
                          attn_backend='reference')
            memo[key] = _serve(eng, JaxRequest, _prompts(jm.cfg.vocab_size))
        return memo[key]
    return get


@pytest.mark.parametrize('kind,paged,chunk,pack',
                         [('glm4', False, 1, False),
                          ('deepseek', True, 4, True)],
                         ids=['glm4-dense-chunk1', 'deepseek-paged-packed'])
def test_async_matches_jax_sync(models, jax_sync, kind, paged, chunk, pack):
    """The port's async loop gives the greedy tokens of JAX's synchronous
    engine. At chunk 1 a prompt's tokens go through the one-token step,
    which the port feeds from the slot's stream."""
    _, _, tm, tp = models(kind)
    eng = _port(tm, tp, paged, chunk=chunk, pack_prefill=pack,
                async_loop=True)
    assert _serve(eng, Request, _prompts(tm.cfg.vocab_size)) \
        == jax_sync(kind, paged, chunk)


# ---------------------------------------------------------------- contract
def _records(eng, monkeypatch):
    """Every commit record the engine dispatches, in order."""
    seen, dispatch = [], eng._dispatch

    def spy(*args):
        rec = dispatch(*args)
        if rec is not None:
            seen.append(rec)
        return rec
    monkeypatch.setattr(eng, '_dispatch', spy)
    return seen


def test_eos_lane_dispatched_speculatively_and_discarded(models,
                                                         monkeypatch):
    """uid 1 stops at an EOS, its second token: the async loop cannot
    predict that, so it dispatches one more lane for uid 1, whose commit
    is discarded. Tokens equal the synchronous loop's."""
    _, _, tm, tp = models('glm4')
    prompts = _prompts(tm.cfg.vocab_size)
    eos = _serve(_port(tm, tp), Request, prompts)[1][1]
    out, lanes = [], []
    for async_loop in (False, True):
        eng = _port(tm, tp, async_loop=async_loop)
        recs = _records(eng, monkeypatch)
        reqs = _submit(eng, Request, prompts)
        reqs[1].eos_id = eos
        eng.run()
        assert all(r.status is RequestStatus.FINISHED for r in reqs)
        out.append([r.generated for r in reqs])
        lanes.append(sum(ln.req.uid == 1 for rec in recs
                         for ln in rec.lanes))
    assert out[1] == out[0] and out[0][1][-1] == eos and len(out[0][1]) == 2
    assert lanes[1] == lanes[0] + 1, lanes


def test_cancel_and_deadline_while_in_flight(models):
    """With uid 1's and uid 2's decode lanes in flight, uid 1 is cancelled
    and uid 2's deadline expires: their pending lanes are discarded, both
    end so (CANCELLED, FAILED('deadline_exceeded')), the other requests
    get the synchronous loop's tokens, and no page leaks."""
    _, _, tm, tp = models('glm4')
    prompts = _prompts(tm.cfg.vocab_size)
    want = _serve(_port(tm, tp), Request, prompts)
    eng = _port(tm, tp, async_loop=True)
    reqs = _submit(eng, Request, prompts)

    def in_flight(uid):
        return eng._pending is not None and any(
            ln.req.uid == uid and ln.gen for ln in eng._pending.lanes)
    while not (in_flight(1) and in_flight(2)):
        eng.step_once()
    lag = len(reqs[1].generated)
    assert eng.cancel(1)
    reqs[2].deadline_s = 0.0
    eng.run()
    assert reqs[1].status is RequestStatus.CANCELLED
    assert len(reqs[1].generated) == lag
    assert reqs[2].status is RequestStatus.FAILED \
        and reqs[2].error == 'deadline_exceeded'
    for i in (0, 3, 4):
        assert reqs[i].status is RequestStatus.FINISHED
        assert reqs[i].generated == want[i]
    _no_leak(eng)


@pytest.mark.parametrize('kind', ['glm4', 'mistral'])
def test_page_steals_preempt_async_as_sync(models, kind):
    """A 16-page pool, 2 slots, JAX's seeded steal schedules (tick, pages,
    hold): the async loop preempts and resumes, and every request finishes
    with the unfaulted synchronous loop's greedy tokens; no page leaks."""
    _, _, tm, tp = models(kind)
    prompts = _prompts(tm.cfg.vocab_size, lens=(28, 23, 21, 25, 25), seed=7)
    kw = dict(max_slots=2, num_pages=16)
    want = _serve(_port(tm, tp, **kw), Request, prompts)
    preempted = 0
    for steal, n, hold in ((3, 10, 6), (9, 6, 9), (14, 12, 4)):
        faults = ScriptedFaults(steal_pages={steal: n},
                                restore_pages_at=(steal + hold,))
        eng = _port(tm, tp, fault_injector=faults, async_loop=True, **kw)
        got = _serve(eng, Request, prompts)
        faults.release_stolen(eng)
        assert got == want, (steal, n, hold)
        preempted += eng.preemptions
        _no_leak(eng)
    assert preempted > 0


def test_ring_snapshot_boundary_flushes(models, monkeypatch):
    """mistral-7b on ring pages, two waves whose second hits the
    snapshots: a pending lane that lands on a snapshot boundary is
    committed (its snapshot captured) before the slot's next chunk is
    dispatched. Tokens and snapshot hits equal the synchronous loop's."""
    _, _, tm, tp = models('mistral')
    first = _prompts(tm.cfg.vocab_size, lens=(30, 37, 26))
    second = [first[1].copy(), first[0][:27].copy()]
    out = []
    for async_loop in (False, True):
        eng = _port(tm, tp, async_loop=async_loop)
        flushes = []
        flush = eng._flush_async

        def spy():
            flushes.append(eng._pending is not None
                           and eng._pending.needs_sync)
            flush()
        monkeypatch.setattr(eng, '_flush_async', spy)
        tokens = _serve(eng, Request, first) \
            + _serve(eng, Request, second)
        out.append((tokens, eng.kv.hits, eng.kv.hit_tokens))
        if async_loop:
            assert sum(flushes) > 0, flushes
        else:
            assert not flushes
    assert out[1] == out[0] and out[0][1] > 0


def test_one_step_lag_and_drain(models):
    """One request: after the dispatch that samples its first token the
    host holds no token yet; the next tick commits it. ``run()`` returns
    with nothing in flight, and so does ``score()``."""
    _, _, tm, tp = models('glm4')
    prompt = _prompts(tm.cfg.vocab_size, lens=(6,))[0]
    eng = _port(tm, tp, async_loop=True)
    req = _submit(eng, Request, [prompt])[0]
    eng.step_once()                       # prefill 4 tokens
    eng.step_once()                       # prefill 2: samples token 1
    assert eng._pending is not None and eng._pending.lanes[0].gen
    assert req.generated == [] and req.status is RequestStatus.PREFILLING
    eng.step_once()                       # decode; commits token 1
    assert len(req.generated) == 1 and eng._pending.lanes[0].gen
    eng.run()
    assert eng._pending is None and req.status is RequestStatus.FINISHED
    assert req.generated == _serve(_port(tm, tp), Request, [prompt])[0]
    eng.score([prompt])
    assert eng._pending is None


def test_overlap_histogram_observed(models):
    """With telemetry, the async engine observes ``engine.step.overlap_s``
    once a dispatch with a step in flight, and every committed step's
    five phases (``sample_commit`` one tick later); the synchronous engine
    registers no overlap series. Tokens are bitwise either way."""
    _, _, tm, tp = models('glm4')
    prompts = _prompts(tm.cfg.vocab_size)
    tokens, series = [], []
    for async_loop in (False, True):
        eng = _port(tm, tp, async_loop=async_loop, telemetry=True)
        tokens.append(_serve(eng, Request, prompts))
        snap = eng.metrics()['metrics']['histograms']
        overlap = [v for k, v in snap.items()
                   if k.startswith(TM.STEP_OVERLAP)]
        commits = sum(v['count'] for k, v in snap.items()
                      if k.startswith(TM.STEP_PHASE)
                      and 'sample_commit' in k)
        assert commits == eng.steps
        series.append(overlap)
    assert tokens[1] == tokens[0]
    assert series[0] == [] and len(series[1]) == 1
    assert 0 < series[1][0]['count'] < eng.steps


def test_mesh_with_async_raises_and_with_packing_serves(models):
    """``mesh`` + ``async_loop`` is ROADMAP A.3 and raises; ``mesh`` +
    ``pack_prefill`` runs the same packed forward on the gathered state:
    tokens bitwise the unsharded packed engine's."""
    _, _, tm, tp = models('glm4')
    mesh = make_serving_mesh('2x2', devices=['cpu'] * 4)
    with pytest.raises(NotImplementedError, match='A.3'):
        _port(tm, tp, mesh=mesh, async_loop=True)
    prompts = _prompts(tm.cfg.vocab_size)
    got = _serve(_port(tm, tp, mesh=mesh, pack_prefill=True), Request,
                 prompts)
    assert got == _serve(_port(tm, tp, pack_prefill=True), Request, prompts)


def test_cli_async_loop_serves(monkeypatch):
    """``launch/serve.py --async-loop`` serves on the CPU and says so."""
    monkeypatch.setattr(sys, 'argv', [
        'serve', '--device', 'cpu', '--arch', 'glm4-9b', '--prefix-cache',
        '--requests', '3', '--new-tokens', '3', '--async-loop'])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main()
    text = buf.getvalue()
    assert 'async double-buffered host loop (one-step sampling lag)' in text
    assert '3 requests, 9 new tokens' in text


def test_async_packed_replay_scenario_on_cpu():
    """The scenario of the ``cuda`` twin, on the CPU (no capture there):
    the 16-slot paged engine with packing and the async loop gives the
    tokens and score logits of the synchronous unpacked engine inside
    ``_eager_steps()``, bitwise; packed programs ran at bucket 8."""
    got, want, got_logits, want_logits, info = \
        async_packed_vs_eager_run('cpu')
    assert got == want
    assert [x.tobytes() for x in got_logits] \
        == [x.tobytes() for x in want_logits]
    assert info['packed'] and {k[1] for k in info['packed']} == {8}
    assert info['graphs'] == 0
