"""The port's paged engine on windowed layers (ring pages with snapshots)
against the JAX package's paged engine, on the same numpy weights.

Configs: mistral-7b's smoke config (all ``'local'``, window 8, fp32) and
the mixed ``('global', 'local')`` config of ``tests/test_paged_prefix.py``
(``paged-local``), each built in both packages. Page 8, max_seq 64, chunk 1
and 4: ``sc_ring`` 8 and 11 (one ring page, and two with a partial last
page). Prompts of 24-40 tokens wrap every ring; the second wave holds a
second turn (a wave-1 prompt, its greedy tokens and a new tail) and a
resubmitted prompt, which hit the snapshots published at the last page
boundary before each prompt's final token, and a prompt that stops inside
a cached page (a hit without copy-on-write).

What must be equal, exactly: greedy tokens, per-request
``prefix_hit_tokens`` and ``stats()`` (hits, misses, hit tokens, pages in
use, evictions, preemptions) against JAX's engine with
``attn_backend='reference'``, for both port backends (on the CPU the
``cuda`` backend runs the kernels' plain versions through the fused,
deferred-clear write path); inside the port, paged tokens equal dense ones
and the pools, ring pages and snapshots of the two backends are bitwise
equal. The ``cuda`` twin on the card is phase 9 of ``chip_smoke.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JaxModelConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.config import ModelConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.attn_backend import ReferenceBackend
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, RequestStatus, ServingEngine

PS = 8
MAX_SEQ = 64
NEW = 6
STATS = ('prefix_hits', 'prefix_misses', 'prefix_hit_tokens', 'pages_in_use',
         'evictions', 'preemptions')
# a pool too small for two requests of the traffic at once (8 linear +
# ring pages a request), so the second one preempts or waits
SMALL_POOL = 12


def _mixed(cls):
    """``paged-local`` of ``tests/test_paged_prefix.py``."""
    return cls(name='paged-local', arch_class='dense', num_layers=2,
               d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
               vocab_size=211, max_seq_len=256, dtype='float32',
               pattern=('global', 'local'), window=8)


@pytest.fixture(scope='module')
def models():
    memo = {}

    def get(kind):
        if kind not in memo:
            if kind == 'local':
                jcfg, tcfg = (jax_smoke_config('mistral_7b'),
                              get_smoke_config('mistral_7b'))
            else:
                jcfg, tcfg = _mixed(JaxModelConfig), _mixed(ModelConfig)
            jm = JaxModel(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            tm = Model(tcfg)
            tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
            memo[kind] = (jm, jp, tm, tp)
        return memo[kind]
    return get


def _first_wave(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in (30, 37, 26)]


def _serve(eng, req_cls, vocab):
    """Two waves on one engine. Wave 1: prompts of 30, 37 and 26 tokens
    (each publishes a snapshot at 24, 32 and 24). Wave 2: the first
    prompt's second turn (prompt + its greedy tokens + 5 new; hit 24), the
    second prompt again (hit 32), and the first prompt's first 27 tokens
    (hit 24, stops inside the cached page: no copy-on-write). -> the
    requests."""
    first = [req_cls(uid=i, prompt=p, max_new_tokens=NEW)
             for i, p in enumerate(_first_wave(vocab))]
    for r in first:
        eng.submit(r)
    eng.run()
    a, b = first[0], first[1]
    tail = np.random.default_rng(4).integers(3, vocab, 5).astype(np.int32)
    second = [np.concatenate([a.prompt, np.asarray(a.generated, np.int32),
                              tail]), b.prompt.copy(), a.prompt[:27].copy()]
    second = [req_cls(uid=10 + i, prompt=p, max_new_tokens=NEW)
              for i, p in enumerate(second)]
    for r in second:
        eng.submit(r)
    eng.run()
    return first + second


def _outcome(eng, reqs):
    assert all(r.status.name == 'FINISHED' for r in reqs), \
        [(r.uid, r.status, r.error) for r in reqs]
    stats = eng.stats(reqs)
    return ([list(r.generated) for r in reqs],
            [r.prefix_hit_tokens for r in reqs],
            {k: stats[k] for k in STATS})


def _engine(cls, model, params, chunk, **kw):
    kw.setdefault('max_slots', 2)
    return cls(model, params, max_seq=MAX_SEQ, chunk_size=chunk,
               prefix_cache=True, page_size=PS, **kw)


@pytest.fixture(scope='module')
def jax_runs(models):
    """JAX paged engine outcomes per (kind, chunk, kv_quant, num_pages)."""
    memo = {}

    def get(kind, chunk, kv_quant=False, num_pages=None):
        key = (kind, chunk, kv_quant, num_pages)
        if key not in memo:
            jm, jp, _, _ = models(kind)
            eng = _engine(JaxEngine, jm, jp, chunk, kv_quant=kv_quant,
                          num_pages=num_pages, attn_backend='reference')
            memo[key] = _outcome(eng, _serve(eng, JaxRequest,
                                             jm.cfg.vocab_size))
        return memo[key]
    return get


def _port(models, kind, chunk, backend, **kw):
    _, _, tm, tp = models(kind)
    eng = _engine(ServingEngine, tm, tp, chunk, attn_backend=backend,
                  device='cpu', **kw)
    return eng, _serve(eng, Request, tm.cfg.vocab_size)


def test_ring_geometry_matches_jax(models):
    """``_sc_ring``, ``_pages_ring``, ``_needs_snapshot``, the default
    ``num_pages`` and the ``cannot host`` floor (the smallest pool that
    constructs, and the ValueError one page below it) equal JAX's."""
    for kind in ('local', 'mixed'):
        jm, jp, tm, tp = models(kind)
        for slots, seq, chunk in ((2, 64, 1), (2, 64, 4), (3, 128, 16)):
            kw = dict(max_slots=slots, max_seq=seq, chunk_size=chunk,
                      prefix_cache=True, page_size=PS)
            j = JaxEngine(jm, jp, attn_backend='reference', **kw)
            t = ServingEngine(tm, tp, device='cpu', **kw)
            for attr in ('_sc_ring', '_pages_ring', '_pages_lin',
                         '_needs_snapshot', 'num_pages'):
                assert getattr(t, attr) == getattr(j, attr), (kind, attr)
            assert t._needs_snapshot and t._sc_ring == min(8 + chunk - 1,
                                                           seq)
            floor = 1 + t._pages_ring + 2
            msgs = []
            for cls, m, p, extra in ((JaxEngine, jm, jp,
                                      dict(attn_backend='reference')),
                                     (ServingEngine, tm, tp,
                                      dict(device='cpu'))):
                cls(m, p, **dict(kw, num_pages=floor), **extra)
                with pytest.raises(ValueError, match='cannot host') as e:
                    cls(m, p, **dict(kw, num_pages=floor - 1), **extra)
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1]


@pytest.mark.parametrize('chunk', [1, 4])
@pytest.mark.parametrize('kind', ['local', 'mixed'])
def test_paged_ring_engine_matches_jax(models, jax_runs, kind, chunk):
    """Both port backends: tokens, per-request hits and stats equal JAX's;
    the second wave hits the snapshots, none copies on write."""
    want = jax_runs(kind, chunk)
    assert want[1][3:] == [24, 32, 24] and not any(want[1][:3])
    for backend in ('reference', 'cuda'):
        eng, reqs = _port(models, kind, chunk, backend)
        assert _outcome(eng, reqs) == want, backend
        assert eng.cow_copies == 0 and eng._pending_clear == []
        assert eng._sc_ring == (8 if chunk == 1 else 11)


@pytest.mark.parametrize('kind', ['local', 'mixed'])
def test_ring_preemption_matches_jax(models, jax_runs, kind):
    """A pool too small for two requests: the preemption count, tokens,
    hits and stats equal JAX's, and the tokens equal the unpressured
    run's; chunk 4 (two ring pages) on the cuda backend, chunk 1 on the
    reference backend."""
    for chunk, backend in ((4, 'cuda'), (1, 'reference')):
        want = jax_runs(kind, chunk, num_pages=SMALL_POOL)
        assert want[2]['preemptions'] > 0, want[2]
        assert want[0] == jax_runs(kind, chunk)[0]
        eng, reqs = _port(models, kind, chunk, backend, num_pages=SMALL_POOL)
        assert _outcome(eng, reqs) == want, (chunk, backend)


@pytest.mark.parametrize('kind', ['local', 'mixed'])
def test_ring_int8_matches_jax(models, jax_runs, kind):
    """int8 ring (and linear) pages: tokens, hits and stats equal JAX's
    int8 paged engine's on both backends, at chunk 4."""
    want = jax_runs(kind, 4, kv_quant=True)
    assert want[1][3:] == [24, 32, 24]
    for backend in ('reference', 'cuda'):
        eng, reqs = _port(models, kind, 4, backend, kv_quant=True)
        assert sorted(eng._pools[0][0]) == ['k', 'k_scale', 'pos', 'v',
                                            'v_scale']
        assert _outcome(eng, reqs) == want, backend


def _snapshots(eng):
    """Every snapshot of the radix index by its node's token path."""
    out, stack = {}, [(eng.kv.root, b'')]
    while stack:
        node, path = stack.pop()
        if node.snapshot is not None:
            out[path] = node.snapshot
        stack += [(c, path + k) for k, c in node.children.items()]
    return out


class ReferenceAttendKernelWrites(ReferenceBackend):
    """The reference attend with the kernel write path (the fused job
    lists, deferred clears, cow_page_copy), as in ``chip_smoke.py``: it
    isolates the write path, so its pools must equal the reference
    backend's bit for bit."""
    name = 'reference+kernel-writes'
    fused_maintenance = True


def _leaf_names(eng):
    """(layer index, leaf name) of each tensor of a snapshot, in order."""
    return [(i, nm) for i, (layer, _, _) in
            enumerate(eng._layers(eng.states)) for nm in layer]


@pytest.mark.parametrize('kind', ['local', 'mixed'])
def test_ring_paged_equals_dense_and_backends_bitwise(models, kind):
    """Inside the port, with the table and the fused gather-RoPE at chunk
    4, in fp32 and int8: paged tokens (reference, kernel-write and cuda
    backends, each also preempting in a small pool) equal the dense
    engine's. The kernel write path's pools (ring pages included) and
    snapshots equal the plain write path's bit for bit on every leaf; the
    cuda backend's on layer 0 and every position leaf (later layers store
    K/V computed from the attention output, which the kernel's plain
    version matches to 2e-6 in fp32, not bitwise). A snapshot holds one
    tensor a leaf, stacked body leaves whole, with the ring's pages."""
    _, _, tm, tp = models(kind)
    table = tm.build_table(tp)
    vocab = tm.cfg.vocab_size
    for kv_quant in (False, True):
        common = dict(max_slots=2, max_seq=MAX_SEQ, chunk_size=4,
                      precomputed=table, fused_gather_rope=True,
                      kv_quant=kv_quant, device='cpu')
        dense = ServingEngine(tm, tp, **common)
        want = [r.generated for r in _serve(dense, Request, vocab)]
        engs = {}
        for backend in ('reference', ReferenceAttendKernelWrites(), 'cuda'):
            label = getattr(backend, 'name', backend)
            for num_pages in (None, SMALL_POOL):
                eng = ServingEngine(tm, tp, prefix_cache=True, page_size=PS,
                                    num_pages=num_pages,
                                    attn_backend=backend, **common)
                assert eng.fused_gather_rope
                got = [r.generated for r in _serve(eng, Request, vocab)]
                assert got == want, (kv_quant, label, num_pages)
                assert eng.preemptions > 0 if num_pages else True
                engs[label, num_pages] = eng
        for (label, num_pages), other in engs.items():
            if label == 'reference':
                continue
            every_leaf = label == 'reference+kernel-writes'
            ref = engs['reference', num_pages]
            names = _leaf_names(ref)
            snaps = _snapshots(ref)
            assert len(snaps) >= 2
            assert other._fused_maint and other._pending_clear == []
            for li, ((ca, _), (cb, _)) in enumerate(zip(ref._pools,
                                                        other._pools)):
                for nm in ca:
                    if every_leaf or li == 0 or nm == 'pos':
                        assert torch.equal(ca[nm], cb[nm]), \
                            (kv_quant, label, num_pages, li, nm)
            theirs = _snapshots(other)
            assert theirs.keys() == snaps.keys()
            for path, snap in snaps.items():
                assert len(snap) == len(names) == len(theirs[path])
                for a, b, (li, nm), (leaf, axis, pooled) in zip(
                        snap, theirs[path], names, ref._snap_plan):
                    assert pooled and a.shape[axis] == ref._pages_ring
                    assert a.shape[:axis] == leaf.shape[:axis]
                    if every_leaf or li == 0 or nm == 'pos':
                        assert torch.equal(a, b), \
                            (kv_quant, label, num_pages, li, nm)


def test_restore_drops_deferred_clears(models, jax_runs):
    """With fused maintenance the ring pages of an admission are still in
    ``_pending_clear`` when its snapshot is restored into them; the
    restore drops those clears. An engine that keeps them wipes the
    restored rings at the next write, and its tokens leave JAX's."""
    _, _, tm, tp = models('local')
    want = jax_runs('local', 4)[0]
    seen = []

    class Spy(ServingEngine):
        def _restore(self, slot, snap):
            ring = set(self.slot_ring[slot])
            seen.append(ring <= set(self._pending_clear))
            super()._restore(slot, snap)

    class KeepsClears(Spy):
        def _drop_pending(self, pages):
            pass

    for cls in (Spy, KeepsClears):
        eng = _engine(cls, tm, tp, 4, attn_backend='cuda', device='cpu')
        got = [r.generated for r in _serve(eng, Request, tm.cfg.vocab_size)]
        assert len(seen) == 3 and all(seen), seen
        assert (got == want) == (cls is Spy), cls.__name__
        seen.clear()


def test_ring_engine_under_mesh_matches_unsharded(models, jax_runs):
    """Paged mistral-7b smoke under a ``2x2`` mesh (the CPU repeated four
    times) with the cuda backend: the unsharded port's tokens, hits and
    stats, which are JAX's."""
    _, _, tm, tp = models('local')
    mesh = make_serving_mesh('2x2', devices=['cpu'] * 4)
    eng = _engine(ServingEngine, tm, tp, 4, attn_backend='cuda',
                  device='cpu', mesh=mesh, num_pages=96)
    reqs = _serve(eng, Request, tm.cfg.vocab_size)
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    unsharded, ureqs = _port(models, 'local', 4, 'cuda', num_pages=96)
    assert _outcome(eng, reqs) == _outcome(unsharded, ureqs)
    assert [r.generated for r in reqs] == jax_runs('local', 4)[0]
