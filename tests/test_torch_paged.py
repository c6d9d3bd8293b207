"""The port's paged KV pool and prefix cache against the JAX package.

- Kernels: ``build_jobs`` equals JAX's exactly; the plain versions of
  ``fused_page_write`` and ``cow_page_copy`` equal the JAX Pallas kernels
  run in interpret mode, bitwise.
- ``serving/kvpool.py`` behaves like JAX's ``PrefixCache`` over one seeded
  sequence of allocator and radix operations.
- Engine: on the glm4-9b smoke config in fp32 with the same weights, the
  port's paged engine (both backends; on the CPU the ``cuda`` backend's
  kernel wrappers run their plain versions) gives the JAX paged engine's
  greedy tokens (``attn_backend='reference'``), per-request prefix hits
  (copy-on-write included) and preemption count; inside the port paged
  equals dense exactly, and a pressured pool gives the unpressured tokens.

The ``cuda``-marked tests of the two CUDA kernels against their plain
versions are in ``tests/test_torch_kernels.py``, which runs on a card
without JAX.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import paged_maintenance as JPM
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.kvpool import PrefixCache as JaxPrefixCache
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import paged_maintenance as PM
from repro_torch.models import attention as A
from repro_torch.models.attn_backend import ReferenceBackend
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, RequestStatus, ServingEngine
from repro_torch.serving.kvpool import PrefixCache

from _torch_scenarios import cow_retaken_run

PS = 8
MAX_SEQ = 64


# ------------------------------------------------------------------ jobs
@pytest.mark.parametrize('ps,Sc,T', [(8, 64, 4), (8, 11, 4), (4, 10, 4),
                                     (16, 2048, 16), (16, 2048, 1)])
def test_build_jobs_matches_jax(ps, Sc, T):
    rng = np.random.default_rng(Sc + T)
    B = 4
    P = -(-Sc // ps)
    table = rng.integers(0, 50, (B, P)).astype(np.int32)
    pos0 = rng.integers(0, 3 * Sc, B).astype(np.int32)
    n_valid = rng.integers(0, T + 1, B).astype(np.int32)
    pending = np.zeros(6, np.int32)
    pending[:4] = [table[0, (pos0[0] % Sc) // ps], 51, 52, table[2, 0]]
    want = JPM.build_jobs(*map(jnp.asarray, (pos0, n_valid, table)), Sc, ps,
                          T, jnp.asarray(pending))
    got = PM.build_jobs(*map(torch.from_numpy, (pos0, n_valid, table)), Sc,
                        ps, T, torch.from_numpy(pending))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ fused_page_write
def _pool(seed, NP, ps, dtype=np.float32):
    rng = np.random.default_rng(seed)
    pool = {'k': rng.standard_normal((NP, ps, 2, 8)).astype(dtype),
            'v': rng.standard_normal((NP, ps, 2, 8)).astype(dtype),
            'pos': rng.integers(0, 99, (NP, ps)).astype(np.int32)}
    for nm, leaf in pool.items():
        leaf[0] = PM.leaf_fill(nm)
    return pool


@pytest.mark.parametrize('ps,Sc', [(8, 32), (8, 11), (4, 10)])
def test_fused_page_write_plain_matches_jax_bitwise(ps, Sc):
    """Ring wraparound (slot 0), a cold slot whose first page is pending
    (slot 1), an inactive slot (slot 2), two pending pages not written
    (whole-page clears) and zero padding in the pending list."""
    B, T = 3, 4
    P = -(-Sc // ps)
    NP = 1 + B * P + 3
    table = np.arange(B * P).reshape(B, P).astype(np.int32) + 1
    pool = _pool(7, NP, ps)
    rng = np.random.default_rng(5)
    vals = {'k': rng.standard_normal((B, T, 2, 8)).astype(np.float32),
            'v': rng.standard_normal((B, T, 2, 8)).astype(np.float32)}
    pos0 = np.array([Sc - 2, 0, 0], np.int32)
    n_valid = np.array([T, T - 1, 0], np.int32)
    pending = np.zeros(8, np.int32)
    pending[:3] = [table[1, 0], NP - 1, NP - 2]

    jobs = JPM.build_jobs(*map(jnp.asarray, (pos0, n_valid, table)), Sc, ps,
                          T, jnp.asarray(pending))
    pos_t = pos0[:, None] + np.arange(T, dtype=np.int32)[None]
    jvals = dict(vals, pos=pos_t)
    tjobs = PM.build_jobs(*map(torch.from_numpy, (pos0, n_valid, table)), Sc,
                          ps, T, torch.from_numpy(pending))
    for nm, leaf in pool.items():
        want = JPM.fused_page_write(jnp.asarray(leaf), jnp.asarray(jvals[nm]),
                                    jobs, Sc=Sc, fill=PM.leaf_fill(nm),
                                    interpret=True)
        got = PM.fused_page_write_plain(
            torch.from_numpy(leaf.copy()), torch.from_numpy(jvals[nm]),
            tjobs, Sc=Sc, fill=PM.leaf_fill(nm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=nm)
    # one multi-leaf write == eager clears + the plain paged scatter
    fused = {nm: torch.from_numpy(v.copy()) for nm, v in pool.items()}
    PM.fused_chunk_scatter(fused, {nm: torch.from_numpy(v)
                                   for nm, v in vals.items()},
                           tjobs, torch.from_numpy(pos_t), Sc=Sc)
    eager = {nm: torch.from_numpy(v.copy()) for nm, v in pool.items()}
    for nm, leaf in eager.items():
        leaf[torch.from_numpy(pending[:3]).long()] = PM.leaf_fill(nm)
    A.paged_scatter(eager, {nm: torch.from_numpy(v)
                            for nm, v in vals.items()},
                    torch.from_numpy(pos0), torch.from_numpy(n_valid),
                    torch.from_numpy(table), Sc)
    for nm in pool:
        assert torch.equal(fused[nm], eager[nm]), nm


# --------------------------------------------------------- cow_page_copy
def test_cow_page_copy_plain_matches_jax_bitwise():
    """rem 0 (pure clear), 3, and ps (pure copy), on a K/V leaf and the
    position leaf's -1 fill."""
    NP, ps = 6, 8
    pool = _pool(3, NP, ps)
    sdr = np.array([[1, 2, 3], [4, 5, 0], [3, 1, ps]], np.int32)
    for nm in ('k', 'pos'):
        fill = PM.leaf_fill(nm)
        want = JPM.cow_page_copy(jnp.asarray(pool[nm]), jnp.asarray(sdr),
                                 fill=fill, interpret=True)
        got = PM.cow_page_copy_plain(torch.from_numpy(pool[nm].copy()),
                                     torch.from_numpy(sdr), fill=fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=nm)


def test_cow_copy_cache_stacked_leaves_one_job_per_layer():
    """Leaves stacked over 3 layers: every layer's dst page becomes its own
    src page's head, other pages untouched."""
    NP, ps, reps = 5, 4, 3
    rng = np.random.default_rng(0)
    cache = {'k': torch.from_numpy(rng.standard_normal(
                 (reps, NP, ps, 2, 8)).astype(np.float32)),
             'pos': torch.from_numpy(rng.integers(0, 50, (reps, NP, ps))
                                     .astype(np.int32))}
    want = {nm: v.clone() for nm, v in cache.items()}
    for nm, leaf in want.items():
        row = leaf[:, 2].clone()
        row[:, 3:] = PM.leaf_fill(nm)
        leaf[:, 4] = row
    PM.cow_copy_cache(cache, 2, 4, 3, reps=reps)
    for nm in cache:
        assert torch.equal(cache[nm], want[nm]), nm


def test_cpu_maintenance_wrappers_count_no_launch():
    pool = torch.zeros(4, 2, 3)
    jobs = torch.tensor([[1, 0, 0, 1, 0, 0]], dtype=torch.int32)
    before = (PM.fused_page_write.launches, PM.cow_page_copy.launches)
    PM.fused_page_write([pool], [torch.ones(1, 1, 3)], jobs, Sc=8, fills=[0])
    PM.cow_page_copy([pool], torch.tensor([[1, 2, 1]], dtype=torch.int32),
                     fills=[0])
    assert (PM.fused_page_write.launches, PM.cow_page_copy.launches) \
        == before
    assert pool[1, 0].tolist() == [1.0] * 3
    assert pool[2, 0].tolist() == [1.0] * 3


# ----------------------------------------------------------------- kvpool
def test_prefix_cache_copy_behaves_like_jax():
    """One seeded stream of alloc / insert / match / find_extension /
    attach / release / free under pool pressure (so LRU eviction runs):
    every result, the free list and the stats agree after each step."""
    ps = 4
    pools = (PrefixCache(12, ps), JaxPrefixCache(12, ps))
    rng = np.random.default_rng(11)
    bases = [rng.integers(0, 6, 16) for _ in range(3)]
    held = [[], []]            # attached nodes, per pool, in the same order
    for step in range(120):
        op = int(rng.integers(0, 5))
        toks = bases[int(rng.integers(0, 3))].copy()
        toks[int(rng.integers(4, 16)):] = rng.integers(0, 6)
        nb = int(rng.integers(1, 4))
        cut = int(rng.integers(1, 4))
        outs = []
        for kv, mine in zip(pools, held):
            if op == 0:                                   # publish a prompt
                pages = kv.alloc(nb)
                if pages is None:
                    outs.append(None)
                    continue
                node, moved = kv.insert(toks, nb, pages)
                kv.free([p for p in pages if p not in set(moved)])
                outs.append((sorted(moved), node.depth))
            elif op == 1:                                 # match + attach
                res = kv.match(toks, max_tokens=len(toks) - 1)
                kv.attach(res.node)
                mine.append(res.node)
                outs.append((res.n_blocks, res.pages))
            elif op == 2 and mine:                        # release oldest
                kv.release(mine.pop(0))
                outs.append('released')
            elif op == 3:                                 # COW source
                res = kv.match(toks)
                outs.append(kv.find_extension(res.node,
                                              toks[res.n_blocks * ps:][:cut]))
            else:                                         # transient alloc
                pages = kv.alloc(nb)
                if pages is not None:
                    kv.free(pages)
                outs.append(pages)
        assert outs[0] == outs[1], (step, op, outs)
        assert pools[0]._free == pools[1]._free, step
        assert pools[0].stats() == pools[1].stats(), step
    assert pools[0].evictions > 0


# ----------------------------------------------------------------- engine
@pytest.fixture(scope='module')
def both():
    jm = JaxModel(jax_smoke_config('glm4_9b'))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config('glm4_9b'))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
    return jm, jp, tm, tp


def _shared_prompts(seed=1):
    """A 24-token shared prefix (3 pages); distinct tails, one of them a
    head of another's tail, and one prompt that is the prefix itself:
    both stop short inside a cached page (copy-on-write)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, 503, 24).astype(np.int32)
    tails = [rng.integers(3, 503, n).astype(np.int32) for n in (13, 5, 9)]
    prompts = [np.concatenate([prefix, t]) for t in tails]
    prompts += [np.concatenate([prefix, tails[0][:4]]), prefix.copy(),
                np.concatenate([prefix, tails[2][:2], [7, 7, 7]])]
    return prompts


def _serve(eng, req_cls, prompts, new_tokens=6):
    reqs = [req_cls(uid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


@pytest.fixture(scope='module')
def jax_runs(both):
    """JAX paged-engine results per (chunk, num_pages), made once."""
    jm, jp, _, _ = both
    memo = {}

    def get(chunk, num_pages=None):
        key = (chunk, num_pages)
        if key not in memo:
            eng = JaxEngine(jm, jp, max_slots=2, max_seq=MAX_SEQ,
                            chunk_size=chunk, prefix_cache=True,
                            page_size=PS, num_pages=num_pages,
                            attn_backend='reference')
            reqs = _serve(eng, JaxRequest, _shared_prompts())
            memo[key] = ([r.generated for r in reqs],
                         [r.prefix_hit_tokens for r in reqs],
                         eng.stats(reqs))
        return memo[key]
    return get


def _port(both, **kw):
    _, _, tm, tp = both
    kw.setdefault('page_size', PS)
    return ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ,
                         prefix_cache=True, device='cpu', **kw)


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
@pytest.mark.parametrize('chunk', [1, 4])
def test_paged_engine_matches_jax(both, jax_runs, chunk, backend):
    """Greedy tokens and per-request prefix hits equal the JAX paged
    engine's; the shared-prefix set hits the cache and copies on write."""
    tokens, hits, jstats = jax_runs(chunk)
    eng = _port(both, chunk_size=chunk, attn_backend=backend)
    assert eng.attn_backend.fused_maintenance == (backend == 'cuda')
    reqs = _serve(eng, Request, _shared_prompts())
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert [r.generated for r in reqs] == tokens
    assert [r.prefix_hit_tokens for r in reqs] == hits
    stats = eng.stats(reqs)
    for key in ('prefix_hits', 'prefix_misses', 'prefix_hit_tokens',
                'pages_in_use', 'evictions', 'preemptions'):
        assert stats[key] == jstats[key], key
    assert stats['prefix_hits'] >= 3 and stats['cow_copies'] >= 2
    assert 23 in hits                        # the prompt == prefix case


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
def test_preemption_count_and_tokens_match_jax(both, jax_runs, backend):
    """A pool of 9 pages cannot hold two requests: preemptions and tokens
    equal JAX's, and the tokens equal an unpressured run's."""
    tokens, _, jstats = jax_runs(4, num_pages=9)
    assert jstats['preemptions'] > 0
    eng = _port(both, chunk_size=4, attn_backend=backend, num_pages=9)
    reqs = _serve(eng, Request, _shared_prompts())
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert eng.stats(reqs)['preemptions'] == jstats['preemptions']
    assert sum(r.preemptions for r in reqs) == jstats['preemptions']
    assert [r.generated for r in reqs] == tokens == jax_runs(4)[0]


@pytest.mark.parametrize('chunk', [1, 4])
def test_paged_equals_dense_exactly(both, chunk):
    """Same weights, same requests, the precomputed table with fused
    gather→RoPE: the paged engine's greedy tokens are the dense engine's,
    cold and on prefix hits."""
    _, _, tm, tp = both
    table = tm.build_table(tp)
    out = {}
    for paged in (False, True):
        kw = dict(prefix_cache=True, page_size=PS) if paged else {}
        eng = ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ,
                            chunk_size=chunk, precomputed=table,
                            fused_gather_rope=True, device='cpu', **kw)
        out[paged] = [r.generated for r in
                      _serve(eng, Request, _shared_prompts(2), 8)]
    assert out[True] == out[False]


def test_pool_contents_equal_between_backends(both):
    """After the same requests, every pool leaf written by the fused
    kernel path (plain versions here) equals the reference path's plain
    scatters with eager clears, bit for bit."""
    engs = [_port(both, chunk_size=4, attn_backend=b, num_pages=12)
            for b in ('reference', 'cuda')]
    for eng in engs:
        _serve(eng, Request, _shared_prompts(3))
        assert eng._pending_clear == []
    for (ca, _), (cb, _) in zip(engs[0]._pools, engs[1]._pools):
        for nm in ca:
            assert torch.equal(ca[nm], cb[nm]), nm


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


class _KernelWrites(ReferenceBackend):
    """The reference attend with the fused page-write path."""
    name = 'reference+kernel-writes'
    fused_maintenance = True


def test_model_fused_paged_write_needs_job_list(both):
    """Through the public model API a fused_maintenance backend writes
    pages only from the step's job list: without one it raises instead of
    taking the plain scatter; with ``PageTables.with_jobs`` (pending clears
    included) states and logits equal the plain write path's bitwise."""
    _, _, tm, tp = both
    B, T, NP = 2, 4, 9
    pt = np.zeros((B, MAX_SEQ // PS), np.int32)
    pt[0, :2], pt[1, :1] = [1, 2], [3]
    pos0 = torch.tensor([6, 3], dtype=torch.int32)
    n_valid = torch.tensor([4, 3], dtype=torch.int32)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        3, 503, (B, T)).astype(np.int32))
    out = {}
    for backend in (ReferenceBackend(), _KernelWrites(), 'cuda'):
        states = tm.make_states(B, MAX_SEQ, dtype=torch.float32,
                                device='cpu', num_pages=NP, page_size=PS)
        paged = A.PageTables(torch.from_numpy(pt), torch.from_numpy(pt[:, :0]),
                             0, torch.tensor([2, 5], dtype=torch.int32))
        kw = dict(n_valid=n_valid, attn_backend=backend)
        if backend == 'cuda' or backend.fused_maintenance:
            with pytest.raises(ValueError, match='job list'):
                tm.decode_step(tp, tok, states, pos0, paged=paged, **kw)
            paged = paged.with_jobs(pos0, n_valid, PS, T)
            states = tm.make_states(B, MAX_SEQ, dtype=torch.float32,
                                    device='cpu', num_pages=NP,
                                    page_size=PS)
        logits, states = tm.decode_step(tp, tok, states, pos0, paged=paged,
                                        **kw)
        out[getattr(backend, 'name', backend)] = (logits, _leaves(states))
    (lr, sr), (lk, sk) = out['reference'], out['reference+kernel-writes']
    assert torch.equal(lr, lk)
    assert len(sr) == len(sk) and all(map(torch.equal, sr, sk))
    assert torch.isfinite(out['cuda'][0]).all()


def test_paged_scoring_stays_cold_and_matches_dense(both):
    _, _, tm, tp = both
    prompts = _shared_prompts()[:2]
    eng = _port(both, chunk_size=4)
    _serve(eng, Request, prompts)
    got = eng.score(prompts)
    want = ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ, chunk_size=4,
                         device='cpu').score(prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_paged_engine_validation(both):
    with pytest.raises(ValueError, match='multiple of page_size'):
        _port(both, page_size=12)
    with pytest.raises(ValueError, match='cannot host'):
        _port(both, num_pages=2)


def test_unschedulable_request_fails_alone(both):
    """A prompt whose pages cannot fit the pool even alone fails as
    unschedulable instead of wedging the engine."""
    eng = _port(both, chunk_size=4, num_pages=3)
    big = Request(uid=0, prompt=np.arange(3, 40, dtype=np.int32),
                  max_new_tokens=2)
    ok = Request(uid=1, prompt=np.arange(3, 8, dtype=np.int32),
                 max_new_tokens=2)
    eng.submit(big)
    eng.submit(ok)
    report = eng.run(max_iters=200)
    assert big.status is RequestStatus.FAILED
    assert big.error == 'unschedulable'
    assert ok.status is RequestStatus.FINISHED and report['stalled'] == 0


def test_serve_cli_prefix_cache_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr('sys.argv', [
        'serve', '--device', 'cpu', '--arch', 'glm4-9b', '--requests', '4',
        '--new-tokens', '3', '--chunk-size', '4', '--prefix-cache',
        '--page-size', '8', '--shared-prefix', '16', '--fused-gather-rope',
        '--attn-backend', 'cuda'])
    serve.main()
    out = capsys.readouterr().out
    assert '4 requests, 12 new tokens' in out
    assert 'prefix cache: ' in out and 'hit tokens' in out


# ------------------- a page freed and taken again in one admission pass
@pytest.mark.parametrize('kv_quant', [False, True])
@pytest.mark.parametrize('backend', ['reference', 'cuda'])
def test_cow_page_freed_and_retaken_in_one_pass(backend, kv_quant):
    """B's copy-on-write page is the page A freed in the same admission
    pass (``_torch_scenarios.cow_retaken_run``); with deferred clears (the
    ``cuda`` backend) it was listed twice in ``_pending_clear``, and every
    entry goes, so no later clear wipes the copied rows: both requests'
    greedy tokens equal the dense engine's. On the CPU the ``cuda``
    backend's kernel wrappers run their plain versions. The ``cuda``-marked
    twin, which runs the kernels, is in ``tests/test_torch_kernels.py``."""
    got, dense, seen = cow_retaken_run('cpu', backend, kv_quant)
    assert seen['cow'] and seen['page'] is not None
    assert seen['page'] not in seen['after']
    if backend == 'cuda':             # deferred clears: X was pending
        assert seen['before'].count(seen['page']) == 1
    else:                             # eager clears: nothing is deferred
        assert seen['before'] == seen['after'] == []
    assert got == dense
