"""The port's serving engine (``repro_torch.serving``) against the JAX
engine on the mistral-7b smoke config in fp32, same weights: equal greedy
tokens for chunk sizes 1 and 4, with and without the precomputed table
(the JAX engine pinned to ``attn_backend='reference'``); plus the port's
own request contracts, sampler and histogram."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import telemetry as JTM
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.attn_backend import CUDA, REFERENCE, get_backend
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, RequestStatus, ServingEngine
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.telemetry import Histogram

PROMPT_LENS = (5, 12, 3, 9)


@pytest.fixture(scope='module')
def both():
    jm = JaxModel(jax_smoke_config('mistral_7b'))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config('mistral_7b'))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
    return jm, jp, tm, tp


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 503, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _port_engine(tm, tp, **kw):
    kw.setdefault('max_slots', 3)
    kw.setdefault('max_seq', 32)
    return ServingEngine(tm, tp, device='cpu', **kw)


@pytest.mark.parametrize('chunk', [1, 4])
@pytest.mark.parametrize('table', [False, True])
def test_engine_greedy_tokens_match_jax(both, chunk, table):
    """More requests than slots (slot reuse), mixed prefill/decode steps,
    and with the table at chunk 4 the fused gather→RoPE path."""
    jm, jp, tm, tp = both
    jeng = JaxEngine(jm, jp, max_slots=3, max_seq=32, chunk_size=chunk,
                     precomputed=jm.build_table(jp) if table else None,
                     fused_gather_rope=table, attn_backend='reference')
    jreqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(_prompts())]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    teng = _port_engine(tm, tp, chunk_size=chunk,
                        precomputed=tm.build_table(tp) if table else None,
                        fused_gather_rope=table)
    assert teng.fused_gather_rope == (table and chunk > 1)
    assert teng.attn_backend is REFERENCE       # 'auto' on the CPU
    treqs = [Request(uid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(_prompts())]
    for r in treqs:
        teng.submit(r)
    report = teng.run()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.status is RequestStatus.FINISHED for r in treqs)
    assert report['stalled'] == 0 and 'p50_ttft_s' in report
    stats = teng.stats(treqs)
    assert stats['completed'] == 4 and stats['tokens'] == 24
    if chunk > 1:
        assert stats['lane_tokens'] == jeng.stats(jreqs)['lane_tokens']


def test_engine_cuda_backend_plumbing_matches_reference_on_cpu(both):
    """The kernel backend's page views and lane batching, through the
    kernel wrapper's plain version: same greedy tokens as reference."""
    _, _, tm, tp = both
    out = {}
    for backend in ('reference', 'cuda'):
        eng = _port_engine(tm, tp, chunk_size=4, attn_backend=backend,
                           precomputed=tm.build_table(tp),
                           fused_gather_rope=True)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(_prompts(2))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[backend] = [r.generated for r in reqs]
    assert out['cuda'] == out['reference']


def test_engine_score_matches_jax(both):
    jm, jp, tm, tp = both
    prompts = _prompts(3)[:2]
    want = JaxEngine(jm, jp, max_slots=2, max_seq=32, chunk_size=4,
                     attn_backend='reference').score(prompts)
    got = _port_engine(tm, tp, max_slots=2, chunk_size=4).score(prompts)
    for g, w, p in zip(got, want, prompts):
        assert g.shape == (len(p), 503)
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=2e-3)


def test_submit_validation_and_duplicate_uids(both):
    _, _, tm, tp = both
    eng = _port_engine(tm, tp)
    bad = [Request(uid=1, prompt=np.zeros(0, np.int32)),
           Request(uid=2, prompt=np.ones(32, np.int32)),
           Request(uid=3, prompt=np.ones(4, np.int32), max_new_tokens=0)]
    for r in bad:
        eng.submit(r)
    assert [r.error for r in bad] == ['empty_prompt', 'prompt_too_long',
                                      'max_new_tokens_not_positive']
    assert all(r.status is RequestStatus.FAILED for r in bad)
    eng.submit(Request(uid=7, prompt=np.ones(4, np.int32)))
    with pytest.raises(ValueError, match='already live'):
        eng.submit(Request(uid=7, prompt=np.ones(4, np.int32)))
    eng.run()
    eng.submit(Request(uid=7, prompt=np.ones(4, np.int32), max_new_tokens=2))


def test_deadline_fails_only_the_expired_request(both):
    _, _, tm, tp = both
    eng = _port_engine(tm, tp)
    late = Request(uid=1, prompt=np.ones(4, np.int32), deadline_s=0.0)
    ok = Request(uid=2, prompt=np.ones(4, np.int32), max_new_tokens=3)
    eng.submit(late)
    eng.submit(ok)
    eng.run()
    assert late.status is RequestStatus.FAILED
    assert late.error == 'deadline_exceeded'
    assert ok.status is RequestStatus.FINISHED and len(ok.generated) == 3


@pytest.mark.parametrize('option', [dict(mesh=make_serving_mesh(
                                        '2x2', devices=['cpu'] * 4)),
                                    dict(mesh=make_serving_mesh(
                                        '2x2', devices=['cpu'] * 4),
                                        prefix_cache=True, page_size=8,
                                        async_loop=True),
                                    dict(mesh=make_serving_mesh(
                                        '2x2', devices=['cpu'] * 4),
                                        prefix_cache=True, page_size=8,
                                        async_loop=True, pack_prefill=True)])
def test_unported_engine_options_raise(both, option):
    """Options not ported yet raise: the dense engine under a mesh (a mesh
    is ported for the paged engine only), and a mesh with the async loop
    (ROADMAP A.3), with or without packing. ``prefix_cache=True`` on
    mistral-7b's windowed layers is ported (``tests/test_torch_ring.py``),
    and so are ``telemetry`` and ``fault_injector``
    (``tests/test_torch_telemetry.py``, ``tests/test_torch_faults.py``),
    ``pack_prefill`` (``tests/test_torch_packed.py``) and ``async_loop``
    on one device (``tests/test_torch_async.py``)."""
    _, _, tm, tp = both
    assert tm.cfg.pattern == ('local',) and tm.cfg.window
    match = 'A.3' if option.get('async_loop') else 'not ported'
    with pytest.raises(NotImplementedError, match=match):
        _port_engine(tm, tp, **option)


def test_auto_backend_resolves_by_device():
    assert get_backend('auto', 'cpu') is REFERENCE
    assert get_backend('auto', torch.device('cuda')) is CUDA
    assert get_backend(None) is REFERENCE
    with pytest.raises(ValueError):
        get_backend('pallas')


def test_sampler_greedy_topk_and_seeded_sampling():
    logits = torch.tensor([[0.1, 3.0, 3.0, -1.0], [2.0, 0.0, 1.0, 5.0]])
    greedy = sample_tokens(logits, torch.Generator().manual_seed(0),
                           torch.zeros(2))
    assert greedy.tolist() == [1, 3]                 # first index on ties
    temps = torch.ones(2)
    a = sample_tokens(logits, torch.Generator().manual_seed(5), temps,
                      top_k=2)
    b = sample_tokens(logits, torch.Generator().manual_seed(5), temps,
                      top_k=2)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert a[0].item() in (1, 2) and a[1].item() in (0, 3)


def test_histogram_matches_jax_telemetry():
    vals = np.random.default_rng(0).exponential(0.01, 200)
    got, want = Histogram.of(vals), JTM.Histogram.of(vals)
    for q in (50, 90, 99):
        assert got.percentile(q) == want.percentile(q)
    assert got.mean == want.mean


@pytest.mark.parametrize('argv', [
    ['--chunk-size', '4', '--fused-gather-rope', '--attn-backend', 'cuda'],
    ['--score', '--no-precompute'],
    ['--prefix-cache', '--page-size', '8', '--shared-prefix', '16',
     '--chunk-size', '4', '--slots', '1'],
    ['--arch', 'glm4-9b', '--prefix-cache', '--page-size', '8',
     '--shared-prefix', '16', '--metrics-out', '{tmp}/m.prom',
     '--trace-out', '{tmp}/t.json'],
    ['--prefix-cache', '--page-size', '8', '--max-slots', '16']])
def test_serve_cli_runs_on_cpu(monkeypatch, capsys, tmp_path, argv):
    """With ``--metrics-out`` / ``--trace-out`` (which imply
    ``--telemetry``) the registry is written as Prometheus text and the
    request spans as a Chrome trace with one track per request."""
    from repro_torch.launch import serve
    argv = [a.format(tmp=tmp_path) for a in argv]
    monkeypatch.setattr('sys.argv', ['serve', '--device', 'cpu',
                                     '--requests', '2', '--new-tokens', '3',
                                     *argv])
    serve.main()
    out = capsys.readouterr().out
    assert ('2 requests, 6 new tokens' in out) or ('scored 2 prompts' in out)
    assert ('prefix cache: ' in out) == ('--prefix-cache' in argv)
    assert ('fault tolerance: 0 preemptions, 0 failed, 0 cancelled, '
            '0 deadline-exceeded, 0 stalled' in out) \
        == ('--score' not in argv)
    if '--max-slots' in argv:       # 16 slots, 2 requests: bucket 8
        assert "16 slots; step programs (path, slot bucket, T, logits): " \
            "[('chunk', 8, 1, False), ('chunk', 8, 16, False)]" in out
    if '--metrics-out' in argv:
        prom = (tmp_path / 'm.prom').read_text()
        assert 'engine_step_phase_s_count{backend="reference",' \
            'kind="prefill",phase="dispatch"}' in prom
        assert 'request_latency_s_count 2' in prom
        trace = json.loads((tmp_path / 't.json').read_text())
        tracks = [e['args']['name'] for e in trace['traceEvents']
                  if e['ph'] == 'M' and e['name'] == 'thread_name']
        assert sorted(tracks) == ['engine', 'request 0', 'request 1']
        assert f'metrics -> {tmp_path}/m.prom' in out
