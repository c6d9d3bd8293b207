"""The port's serving telemetry (``repro_torch.serving.telemetry`` and the
engine's recording) against the JAX package's, on the same numpy weights,
traffic and fault script.

- **Registry**: the same hand-fed counters, gauges and histograms give
  JAX's ``prometheus_text()`` and ``snapshot()`` exactly.
- **Engines** (smoke configs of glm4-9b dense and paged, mistral-7b on
  ring pages, deepseek-v2-lite-16b MLA; a page steal that preempts, a
  cancel and a poisoned lane): each request's span events, names and
  attributes (``prefix_hit_tokens``, page ids, tokens, ``generated``,
  ``error``), equal JAX's in order, and so do the engine-global events
  (EVICT, the FAULT_* injections); the registry holds the same series
  (names and label sets), counter and gauge values, and the same number
  of observations in each ``(phase, backend, kind)`` phase series.
- The Chrome trace round-trips through JSON with one track per request.
- A disabled engine makes no recorder call; tokens are bitwise with
  telemetry on and off (dense and paged, temperature 0 and 0.8); under a
  2x2 mesh of CPU devices the phase counts equal the unsharded engine's.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import json

import numpy as np
import pytest

from repro.serving import Request as JaxRequest
from repro.serving import ScriptedFaults as JaxScriptedFaults
from repro.serving import ServingEngine as JaxEngine
from repro.serving import telemetry as JTM
from repro.serving.kvpool import PrefixCache as JaxPrefixCache
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving import (NULL_TELEMETRY, Request, RequestStatus,
                                 ScriptedFaults, ServingEngine, Telemetry)
from repro_torch.serving import telemetry as TM
from repro_torch.serving.kvpool import PrefixCache

from test_torch_faults import (ENGINES, engine, models, prompts,  # noqa
                               serve)

# a steal that preempts (paged), a cancel mid-decode, a poisoned lane
CHAOS = dict(steal_pages={3: 10}, restore_pages_at=(9,),
             cancel_uids={16: [2]}, nan_lanes={20: [1]})
IDS = [f'{k}-{"paged" if p else "dense"}' for k, p in ENGINES]


def spans(tel, uids):
    """Each uid's events without their time stamps."""
    return {u: [(name, attrs) for _, name, attrs in tel.tracer.events(u)]
            for u in uids}


def phase_counts(tel):
    return {labels: h.count
            for labels, h in tel.registry.find(TM.STEP_PHASE).items()}


def registry_view(tel):
    """Series names with label sets; counter and gauge values; histogram
    observation counts (their sums are host times, never equal)."""
    snap = tel.snapshot()['metrics']
    return (snap['counters'], snap['gauges'],
            {k: v['count'] for k, v in snap['histograms'].items()})


@pytest.fixture(scope='module')
def jax_chaos(models):
    memo = {}

    def get(kind, paged):
        if (kind, paged) not in memo:
            jm, jp, _, _ = models(kind)
            eng = engine(JaxEngine, jm, jp, paged,
                         JaxScriptedFaults(**CHAOS), telemetry=True)
            reqs, _ = serve(eng, JaxRequest)
            memo[kind, paged] = (
                spans(eng.telemetry, [None] + [r.uid for r in reqs]),
                registry_view(eng.telemetry), eng.steps)
        return memo[kind, paged]
    return get


def chaos_run(models, kind, paged, telemetry=True, backend='reference'):
    _, _, tm, tp = models(kind)
    eng = engine(ServingEngine, tm, tp, paged, ScriptedFaults(**CHAOS),
                 telemetry=telemetry, attn_backend=backend, device='cpu')
    reqs, report = serve(eng, Request)
    return eng, reqs, report


# ----------------------------------------------------------------- registry
def test_registry_exports_match_jax():
    """The same observations into both packages' recorders: equal
    Prometheus text, snapshots, percentiles and latency summaries."""
    vals = np.random.default_rng(0).exponential(0.01, 300)
    out = []
    for mod in (TM, JTM):
        tel = mod.Telemetry()
        reg = tel.registry
        reg.counter('widgets').inc(3)
        reg.counter(mod.KV_COW_COPIES).inc()
        reg.gauge('pool.depth', fn=lambda: 7)
        reg.gauge(mod.QUEUE_DEPTH).set(2.5)
        for i, v in enumerate(vals):
            reg.histogram(mod.STEP_PHASE, phase=mod.PHASES[i % 5],
                          backend='reference',
                          kind=mod.STEP_KINDS[i % 3]).observe(v)
        reg.histogram(mod.REQUEST_TTFT).observe(0.37)
        reg.histogram(mod.REQUEST_LATENCY)          # empty
        h = mod.Histogram.of(vals)
        out.append((tel.prometheus_text(), tel.snapshot(),
                    [h.percentile(q) for q in (1, 50, 90, 99)], h.snapshot(),
                    mod.latency_summary('ttft_s', vals),
                    mod.latency_summary('ttft_s', [])))
    assert out[0] == out[1]
    assert 'engine_step_phase_s_count{backend="reference",kind="decode",' \
        'phase="host_schedule"}' in out[0][0]
    assert (TM.PHASES, TM.STEP_KINDS, TM.TERMINAL_EVENTS) == \
        (JTM.PHASES, JTM.STEP_KINDS, JTM.TERMINAL_EVENTS)
    assert {k: getattr(TM, k) for k in dir(JTM) if k.startswith('EV_')} == \
        {k: getattr(JTM, k) for k in dir(JTM) if k.startswith('EV_')}


def test_kvpool_gauges_and_evict_events_match_jax():
    """``bind_telemetry``: the pool's gauges and EVICT events over one
    sequence of allocations, inserts and evictions."""
    out = []
    for cache, mod in ((PrefixCache, TM), (JaxPrefixCache, JTM)):
        tel = mod.Telemetry()
        kv = cache(8, 4)
        kv.bind_telemetry(tel)
        toks = np.arange(3, 19, dtype=np.int32)
        for k in range(2):
            pages = kv.alloc(3)
            node, _ = kv.insert(toks + k, 3, pages)
            kv.attach(node)
            kv.release(node)
        kv.alloc(5)                      # evicts cold blocks
        out.append((tel.snapshot(), spans(tel, [None])))
    assert out[0] == out[1]
    assert [n for n, _ in out[0][1][None]] == [TM.EV_EVICT] * 4


# ------------------------------------------------------------ engine spans
@pytest.mark.parametrize('kind,paged', ENGINES, ids=IDS)
def test_spans_and_phase_series_match_jax(models, jax_chaos, kind, paged):
    """Under the chaos script: per-uid spans and the engine-global stream
    equal JAX's, event by event; the registry's series, values and phase
    observation counts too; every phase is observed once a step."""
    want_spans, want_reg, want_steps = jax_chaos(kind, paged)
    eng, reqs, _ = chaos_run(models, kind, paged)
    tel = eng.telemetry
    assert spans(tel, [None] + [r.uid for r in reqs]) == want_spans
    assert registry_view(tel) == want_reg
    assert eng.steps == want_steps
    per_phase = {ph: 0 for ph in TM.PHASES}
    for labels, n in phase_counts(tel).items():
        per_phase[dict(labels)['phase']] += n
    assert set(per_phase.values()) == {eng.steps}
    names = {n for evs in want_spans.values() for n, _ in evs}
    assert {TM.EV_CANCEL, TM.EV_FAIL, TM.EV_FAULT_CANCEL,
            TM.EV_FAULT_POISON} <= names
    if paged:
        assert {TM.EV_PREEMPT, TM.EV_RESUME, TM.EV_FAULT_STEAL,
                TM.EV_FAULT_RESTORE} <= names
    if kind == 'glm4' and paged:
        assert {TM.EV_COW, TM.EV_EVICT} <= names
    metrics = eng.metrics()
    assert metrics['enabled'] and metrics['trace']['n_events'] == \
        sum(map(len, want_spans.values()))


def test_chrome_trace_roundtrip(models):
    """Export -> JSON -> parse: one named track per request (and the
    engine's), time-ordered instants, queued / running slices, the fault
    injections on the engine track."""
    eng, reqs, _ = chaos_run(models, 'glm4', True)
    trace = json.loads(json.dumps(eng.telemetry.chrome_trace()))
    evs = trace['traceEvents']
    threads = {e['tid']: e['args']['name'] for e in evs
               if e['ph'] == 'M' and e['name'] == 'thread_name'}
    assert threads[0] == 'engine'
    assert sorted(v for k, v in threads.items() if k) == \
        sorted(f'request {r.uid}' for r in reqs)
    by_uid, slices = {}, {}
    for ev in evs:
        if ev['ph'] == 'i':
            by_uid.setdefault(ev['args']['uid'], []).append(ev)
        elif ev['ph'] == 'X':
            slices.setdefault(ev['args']['uid'], []).append(ev)
    for r in reqs:
        names = [e['name'] for e in by_uid[r.uid]]
        ts = [e['ts'] for e in by_uid[r.uid]]
        assert ts == sorted(ts)
        assert names[0] == TM.EV_SUBMIT and names[-1] in TM.TERMINAL_EVENTS
        assert {s['name'] for s in slices[r.uid]} <= {'queued', 'running'}
        assert all(s['dur'] >= 0 for s in slices[r.uid])
    assert {TM.EV_FAULT_STEAL, TM.EV_FAULT_CANCEL} <= \
        {e['name'] for e in by_uid[None]}


# --------------------------------------------------------- disabled == free
class _SpyRecorder:
    """enabled=False recorder that fails the test on any other access."""
    enabled = False

    def __getattr__(self, name):
        raise AssertionError(
            f'engine called {name}() on a disabled telemetry recorder')


@pytest.mark.parametrize('paged', [False, True], ids=['dense', 'paged'])
def test_disabled_engine_makes_no_recorder_call(models, paged):
    eng, reqs, _ = chaos_run(models, 'glm4', paged, telemetry=_SpyRecorder())
    assert eng.telemetry.enabled is False
    assert sum(r.status is RequestStatus.FINISHED for r in reqs) == 3


def test_disabled_engines_share_null_singleton(models):
    _, _, tm, tp = models('glm4')
    a = engine(ServingEngine, tm, tp, True, None, device='cpu')
    b = engine(ServingEngine, tm, tp, False, None, telemetry=None,
               device='cpu')
    assert a.telemetry is NULL_TELEMETRY and b.telemetry is NULL_TELEMETRY
    assert a.metrics() == {'enabled': False}
    assert NULL_TELEMETRY.prometheus_text() == ''
    assert NULL_TELEMETRY.chrome_trace()['traceEvents'] == []
    shared = Telemetry()
    c = engine(ServingEngine, tm, tp, True, None, telemetry=shared,
               device='cpu')
    assert c.telemetry is shared and TM.coerce(True) is not shared
    with pytest.raises(TypeError):
        TM.coerce(object())


@pytest.mark.parametrize('temp', [0.0, 0.8])
@pytest.mark.parametrize('paged', [False, True], ids=['dense', 'paged'])
def test_tokens_bitwise_telemetry_on_off(models, paged, temp):
    _, _, tm, tp = models('glm4')
    out = {}
    for tel in (False, True):
        eng = engine(ServingEngine, tm, tp, paged, None, telemetry=tel,
                     device='cpu')
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6, temperature=temp)
                for i, p in enumerate(prompts())]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[tel] = [list(r.generated) for r in reqs]
    assert out[True] == out[False]


def test_cuda_backend_labels_its_phases(models):
    """The ``backend`` label is the port's backend name: the ``cuda``
    backend (its kernels' plain versions on the CPU) labels ``cuda``, with
    the reference engine's counts and spans."""
    ref, ref_reqs, _ = chaos_run(models, 'glm4', True)
    eng, reqs, _ = chaos_run(models, 'glm4', True, backend='cuda')
    got = phase_counts(eng.telemetry)
    assert {dict(lb)['backend'] for lb in got} == {'cuda'}
    relabel = {tuple((k, 'cuda' if k == 'backend' else v) for k, v in lb): n
               for lb, n in phase_counts(ref.telemetry).items()}
    assert got == relabel
    uids = [None] + [r.uid for r in reqs]
    assert spans(eng.telemetry, uids) == spans(ref.telemetry, uids)


def test_mesh_phase_counts_equal_unsharded(models):
    """Paged glm4 smoke under a 2x2 mesh of CPU devices, with the chaos
    script (a cancel mid-decode under the mesh included): the same tokens,
    outcomes, spans and phase observation counts as the unsharded engine;
    the gather and split land in ``dispatch``."""
    _, _, tm, tp = models('glm4')
    base, base_reqs, _ = chaos_run(models, 'glm4', True)
    mesh = make_serving_mesh('2x2', devices=['cpu'] * 4)
    eng = ServingEngine(tm, tp, max_slots=2, max_seq=64, chunk_size=4,
                        prefix_cache=True, page_size=8, num_pages=16,
                        fault_injector=ScriptedFaults(**CHAOS),
                        attn_backend='reference', telemetry=True, mesh=mesh,
                        device='cpu')
    reqs, _ = serve(eng, Request)
    assert [(r.status, r.error, r.generated) for r in reqs] == \
        [(r.status, r.error, r.generated) for r in base_reqs]
    assert reqs[2].status is RequestStatus.CANCELLED
    assert phase_counts(eng.telemetry) == phase_counts(base.telemetry)
    uids = [None] + [r.uid for r in reqs]
    assert spans(eng.telemetry, uids) == spans(base.telemetry, uids)
    assert eng.telemetry.registry.find(TM.STEP_PHASE) and eng._t_mesh > 0
