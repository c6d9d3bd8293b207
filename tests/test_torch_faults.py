"""The port's failure contracts (``cancel(uid)``, the fault injector, the
lane watchdog, preemption under page steals) against the JAX engine, on
the same numpy weights and traffic.

Configs: the smoke configs of glm4-9b (dense, and paged with a
copy-on-write), mistral-7b (paged on ring pages, a snapshot hit) and
deepseek-v2-lite-16b (paged MLA latents), fp32, page 8, ``max_seq`` 64,
chunk 4, 2 slots, a 16-page pool (JAX's ``test_fault_tolerance.py``
setting). Traffic: five prompts, three sharing a two-page prefix; one stops
inside a cached page (a copy-on-write on glm4 and deepseek, a snapshot hit
on mistral).

- **Seeded schedules**: JAX's ``(steal tick, pages, hold)`` examples
  ``(3, 10, 6)``, ``(9, 6, 9)`` and ``(14, 12, 4)`` on the paged configs.
- **Cancels and a poisoned lane**: one queued request cancelled before the
  run, one mid-prefill and one mid-decode through ``ScriptedFaults``, and
  one lane poisoned, on all four engines.

What must be equal to JAX's engine (``attn_backend='reference'``):
statuses, errors, greedy tokens, per-request preemptions and prefix hits,
and the ``run()`` / ``stats()`` counters. Inside the port: tokens under a
schedule equal the unfaulted run's, and no page leaks.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ScriptedFaults as JaxScriptedFaults
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving import (FaultInjector, Request, RequestStatus,
                                 ScriptedFaults, ServingEngine)

PS = 8
MAX_SEQ = 64
NUM_PAGES = 16
NEW = 8
ARCH = {'glm4': 'glm4_9b', 'mistral': 'mistral_7b',
        'deepseek': 'deepseek_v2_lite_16b'}
SCHEDULES = [(3, 10, 6), (9, 6, 9), (14, 12, 4)]
# uid 4 cancelled while queued (before the run), uid 1 mid-prefill at tick
# 3, uid 2 mid-decode at tick 12; slot 0's lane (uid 0, decoding) poisoned
# for the dispatch of step 9
CANCEL_SCRIPT = dict(cancel_uids={3: [1], 12: [2]}, nan_lanes={9: [0]})
RUN_KEYS = ('iters', 'stalled', 'in_flight', 'preemptions', 'failed',
            'cancelled', 'deadline_exceeded')
STAT_KEYS = ('completed', 'tokens', 'engine_steps', 'preemptions', 'failed',
             'cancelled', 'deadline_exceeded', 'stalled', 'lane_tokens')
POOL_KEYS = ('prefix_hits', 'prefix_misses', 'prefix_hit_tokens',
             'pages_in_use', 'pages_free', 'evictions')
ENGINES = [('glm4', False), ('glm4', True), ('mistral', True),
           ('deepseek', True)]


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


def prompts(vocab=503):
    """a and b share a 16-token prefix (two pages) with e; c is a's first
    21 tokens (stops inside a's third page); d shares nothing."""
    rng = np.random.default_rng(7)
    pre = rng.integers(3, vocab, 16)
    a = np.concatenate([pre, rng.integers(3, vocab, 12)])
    b = np.concatenate([pre, rng.integers(3, vocab, 7)])
    d = rng.integers(3, vocab, 25)
    e = np.concatenate([pre, rng.integers(3, vocab, 9)])
    return [p.astype(np.int32) for p in (a, b, a[:21], d, e)]


def serve(eng, req_cls, cancel_queued=False):
    """Submit the five prompts, optionally cancel uid 4 while it is still
    queued, run to the end. -> (requests, run() report)."""
    reqs = [req_cls(uid=i, prompt=p, max_new_tokens=NEW)
            for i, p in enumerate(prompts())]
    for r in reqs:
        eng.submit(r)
    if cancel_queued:
        assert eng.cancel(4)
    report = eng.run(max_iters=5000)
    if isinstance(eng.fault_injector, (ScriptedFaults, JaxScriptedFaults)):
        eng.fault_injector.release_stolen(eng)
    return reqs, report


def engine(cls, model, params, paged, faults, **kw):
    if paged:
        kw.update(prefix_cache=True, page_size=PS, num_pages=NUM_PAGES)
    kw.setdefault('attn_backend', 'reference')
    return cls(model, params, max_slots=2, max_seq=MAX_SEQ, chunk_size=4,
               fault_injector=faults, **kw)


def outcome(eng, reqs, report):
    stats = eng.stats(reqs)
    keys = STAT_KEYS + (POOL_KEYS if eng.kv is not None else ())
    return ([(r.status.name, r.error, list(r.generated), r.preemptions,
              r.prefix_hit_tokens) for r in reqs],
            {k: report[k] for k in RUN_KEYS}, {k: stats[k] for k in keys})


def script(name):
    """-> (fault script kwargs, cancel a queued request first?)"""
    if name == 'cancel':
        return CANCEL_SCRIPT, True
    steal, n, hold = name
    return dict(steal_pages={steal: n},
                restore_pages_at=(steal + hold,)), False


@pytest.fixture(scope='module')
def jax_runs(models):
    memo = {}

    def get(kind, paged, name):
        key = (kind, paged, name)
        if key not in memo:
            jm, jp, _, _ = models(kind)
            faults, queued = script(name)
            eng = engine(JaxEngine, jm, jp, paged,
                         JaxScriptedFaults(**faults))
            memo[key] = outcome(eng, *serve(eng, JaxRequest, queued))
        return memo[key]
    return get


def port_run(models, kind, paged, name):
    _, _, tm, tp = models(kind)
    faults, queued = script(name)
    eng = engine(ServingEngine, tm, tp, paged, ScriptedFaults(**faults),
                 device='cpu')
    reqs, report = serve(eng, Request, queued)
    return eng, reqs, report


def assert_no_leak(eng):
    """Every page is free or held by the radix index, once: nothing leaks
    and nothing is listed twice."""
    kv = eng.kv
    assert all(r is None for r in eng.slot_req)
    radix, stack = [], list(kv.root.children.values())
    while stack:
        node = stack.pop()
        radix.append(node.page)
        stack.extend(node.children.values())
    free = list(kv._free)
    assert kv.pages_in_use() == len(radix)
    assert sorted(free + radix) == list(range(1, kv.num_pages))


@pytest.mark.parametrize('schedule', SCHEDULES, ids=str)
@pytest.mark.parametrize('kind', ['glm4', 'mistral', 'deepseek'])
def test_seeded_fault_schedules_match_jax(models, jax_runs, kind, schedule):
    """A page steal at a tick and its restore ``hold`` ticks later:
    preemptions, resumes and every outcome equal JAX's; every request
    finishes with the unfaulted run's greedy tokens, and no page leaks."""
    want = jax_runs(kind, True, schedule)
    eng, reqs, report = port_run(models, kind, True, schedule)
    assert outcome(eng, reqs, report) == want
    _, _, tm, tp = models(kind)
    clean = engine(ServingEngine, tm, tp, True, None, device='cpu')
    base, _ = serve(clean, Request)
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert [r.generated for r in reqs] == [r.generated for r in base]
    assert_no_leak(eng)


@pytest.mark.parametrize('kind,paged', ENGINES,
                         ids=[f'{k}-{"paged" if p else "dense"}'
                              for k, p in ENGINES])
def test_cancel_and_poisoned_lane_match_jax(models, jax_runs, kind, paged):
    """A queued, a mid-prefill and a mid-decode cancel and a poisoned lane:
    each ends as in JAX's engine (CANCELLED x 3, FAILED('nonfinite_logits')
    once), the survivor's tokens are equal, and so are the counters. The
    cancelled requests' spans show where each one was."""
    want = jax_runs(kind, paged, 'cancel')
    eng, reqs, report = port_run(models, kind, paged, 'cancel')
    assert outcome(eng, reqs, report) == want
    status = [r.status for r in reqs]
    assert status == [RequestStatus.FAILED, RequestStatus.CANCELLED,
                      RequestStatus.CANCELLED, RequestStatus.FINISHED,
                      RequestStatus.CANCELLED]
    assert reqs[0].error == 'nonfinite_logits' and reqs[0].generated
    assert not reqs[1].generated and reqs[2].generated
    assert all(r.terminal for r in reqs)
    assert report['cancelled'] == 3 and report['failed'] == 1
    if paged:
        assert_no_leak(eng)


def test_cancel_unknown_or_terminal_uid_returns_false(models):
    """``cancel`` of a uid never submitted, or already terminal, changes
    nothing and returns False; the base injector's hooks do nothing."""
    _, _, tm, tp = models('glm4')
    eng = engine(ServingEngine, tm, tp, True, FaultInjector(), device='cpu')
    reqs, report = serve(eng, Request)
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert not eng.cancel(0) and not eng.cancel(99)
    assert report['cancelled'] == eng.stats(reqs)['cancelled'] == 0
    r = Request(uid=7, prompt=prompts()[3], max_new_tokens=2)
    eng.submit(r)
    assert not r.terminal and eng.cancel(7) and r.terminal
    assert r.status is RequestStatus.CANCELLED and eng.n_cancelled == 1
    assert eng.run()['cancelled'] == 1
    assert_no_leak(eng)
