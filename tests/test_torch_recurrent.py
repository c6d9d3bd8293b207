"""The recurrent and hybrid families in the port — xlstm-125m (mLSTM /
sLSTM blocks, no positions) and hymba-1.5b (attention beside mamba heads,
meta tokens) — against the JAX package, on the smoke configs in fp32 with
the same (bridged) weights: ``PRNGKey(0)``, norm scales and biases
perturbed (``_torch_scenarios.perturbed``).

Against JAX (JAX's runs memoised per module):

- ``Model.init``'s tree and initialisers;
- the precomputed table (rows ``[x, u1, u2, v, ifg]`` for xlstm's mLSTM
  layer 0, ``[x, q, k, v, x_in, gate]`` for hymba's hybrid layer 0) and
  ``Model.apply`` with and without it (hymba's meta tokens leading the
  sequence), within atol 2e-4 / rtol 2e-3;
- ``decode_step`` token by token without the table and in chunks of 4
  with it (hymba's states first primed with the meta tokens:
  ``transformer.prime_meta_states``), the same tolerance;
- greedy tokens of the dense engine (synchronous loop) equal to JAX's
  engine's, and xlstm through the paged engine with a shared prefix:
  tokens and ``stats()`` (hits, misses, hit tokens) equal to JAX's.

Inside the port, bitwise:

- chunked = token by token (chunks 1, 3 and 8; hidden states before the
  tied head, whose one matmul CPU BLAS may block by row count, and every
  state leaf);
- packed = unpacked and async = sync: greedy tokens and ``score()``
  logits (xlstm dense and paged, hymba dense);
- a slot reset copies the template (sLSTM's ``n`` back to ones, hymba's
  primed meta state) in place: the same prompt served twice in one slot
  gives the same tokens;
- hymba with ``prefix_cache=True`` raises JAX's ``ValueError``; xlstm's
  paged engine has no page leaves, builds no job list and snapshots every
  per-slot leaf; the CLI serves both.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, ServingEngine
from _torch_scenarios import perturbed

TOL = dict(atol=2e-4, rtol=2e-3)
ARCHS = ('xlstm_125m', 'hymba_1_5b')
B, S = 2, 12
MAX_SEQ, PS = 64, 8
# (chunk, table) of the decode comparisons: token by token on the
# embedding, chunks of 4 on the table
DECODE_CASES = [(1, False), (4, True)]
_MEMO = {}


def _models(arch):
    """(JAX model, JAX params, JAX table, port model, port params, port
    table) on one set of weights."""
    if arch not in _MEMO:
        jm = JaxModel(jax_smoke_config(arch))
        tree = perturbed(jax.tree.map(np.asarray,
                                      jm.init(jax.random.PRNGKey(0))))
        jp = jax.tree.map(jnp.asarray, tree)
        tm = Model(get_smoke_config(arch))
        tp = from_numpy_tree(tree, device='cpu')
        _MEMO[arch] = (jm, jp, jm.build_table(jp), tm, tp,
                       tm.build_table(tp))
    return _MEMO[arch]


def _tokens(seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(3, 500, shape) \
        .astype(np.int32)


def _prompts(seed, lengths, prefix=()):
    rng = np.random.default_rng(seed)
    return [np.concatenate([np.asarray(prefix, np.int32),
                            rng.integers(3, 500, n).astype(np.int32)])
            for n in lengths]


def _decode_plan(chunk):
    """(start, n) of each call that advances B slots over S tokens."""
    return [(p, min(chunk, S - p)) for p in range(0, S, chunk)]


@pytest.fixture(scope='module')
def jax_runs():
    """JAX's apply logits (baseline, table) and decode logits a call per
    (chunk, table), per arch."""
    memo = {}

    def get(arch):
        if arch in memo:
            return memo[arch]
        jm, jp, jt, _, _, _ = _models(arch)
        toks = jnp.asarray(_tokens())
        out = {}
        for tab in (False, True):
            fn = jax.jit(lambda p, t, tab=tab: jm.apply(
                p, {'tokens': t}, precomputed=jt if tab else None)[0])
            out['apply', tab] = np.asarray(fn(jp, toks))
        M = jm.cfg.num_meta_tokens
        st0 = jm.make_states(B, MAX_SEQ, jnp.float32, chunk=4)
        if M:
            st0 = jax.jit(lambda p, s: JT.prime_meta_states(
                p, s, jm.cfg, B))(jp, st0)
        for chunk, tab in DECODE_CASES:
            st = st0
            step = jax.jit(lambda p, t, s, pos, nv, tab=tab: jm.decode_step(
                p, t, s, pos, precomputed=jt if tab else None,
                n_valid=None if chunk == 1 else nv))
            lgs = []
            for p0, n in _decode_plan(chunk):
                lg, st = step(jp, toks[:, p0:p0 + n], st,
                              jnp.full((B,), p0 + M, jnp.int32),
                              jnp.full((B,), n, jnp.int32))
                lgs.append(np.asarray(lg))
            out['decode', chunk, tab] = lgs
        memo[arch] = out
        return out
    return get


@pytest.mark.parametrize('arch', ARCHS)
def test_init_params_tree_matches_jax_schema(arch):
    """``Model.init`` makes JAX's tree (leaf shapes and dtypes) with its
    initialisers: mamba's ``a_log`` zeros and ``d_skip`` ones, the meta
    tokens normal(0.02), sLSTM's recurrent ``r_*`` fan_in over (H, dh) —
    stacked leaves over (reps, H, dh)."""
    jm, jp, _, tm, _, _ = _models(arch)
    ti = tm.init(seed=3, device='cpu')
    leaves = jax.tree_util.tree_leaves_with_path(ti)
    assert jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, jp)) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, ti))
    assert [(a.shape, str(a.dtype)) for a in jax.tree_util.tree_leaves(jp)] \
        == [(tuple(t.shape), str(t.dtype)[6:]) for _, t in leaves]
    names = {jax.tree_util.keystr(k): t for k, t in leaves}
    for key, t in names.items():
        if key.endswith("['a_log']"):
            assert not t.any(), key
        if key.endswith("['d_skip']"):
            assert bool((t == 1).all()), key
        if key.endswith("['r_z']"):
            fan_in = t.shape[:-1].numel()
            assert abs(float(t.std()) - fan_in ** -0.5) < 0.2 * fan_in ** -0.5
    if tm.cfg.num_meta_tokens:
        assert abs(float(ti['meta'].std()) - 0.02) < 0.01


@pytest.mark.parametrize('arch', ARCHS)
def test_table_matches_jax(arch):
    _, _, jt, _, _, tt = _models(arch)
    assert tt.layout == jt.layout
    np.testing.assert_allclose(tt.table.numpy(), np.asarray(jt.table), **TOL)


@pytest.mark.parametrize('table', [False, True], ids=['base', 'table'])
@pytest.mark.parametrize('arch', ARCHS)
def test_apply_matches_jax(arch, table, jax_runs):
    _, _, _, tm, tp, tt = _models(arch)
    got, _ = tm.apply(tp, {'tokens': torch.from_numpy(_tokens())},
                      precomputed=tt if table else None)
    np.testing.assert_allclose(got.numpy(), jax_runs(arch)['apply', table],
                               **TOL)


@pytest.mark.parametrize('chunk,table', DECODE_CASES)
@pytest.mark.parametrize('arch', ARCHS)
def test_decode_matches_jax(arch, chunk, table, jax_runs):
    """``decode_step`` over the same calls as JAX's (the reference
    attention backend), logits within the tolerance at every call."""
    _, _, _, tm, tp, tt = _models(arch)
    M = tm.cfg.num_meta_tokens
    st = tm.make_states(B, MAX_SEQ, torch.float32, chunk=4, device='cpu')
    if M:
        T.prime_meta_states(tp, st, tm.cfg, B)
    toks = _tokens()
    want = jax_runs(arch)['decode', chunk, table]
    for (p0, n), jl in zip(_decode_plan(chunk), want):
        kw = {} if chunk == 1 else dict(
            n_valid=torch.full((B,), n, dtype=torch.int32))
        lg, st = tm.decode_step(tp, torch.from_numpy(toks[:, p0:p0 + n]), st,
                                torch.full((B,), p0 + M, dtype=torch.int32),
                                precomputed=tt if table else None,
                                attn_backend='reference', **kw)
        np.testing.assert_allclose(lg.numpy(), jl, **TOL)


def _serve(eng, prompts, new=5, score=False):
    reqs = [(Request if isinstance(eng, ServingEngine) else JaxRequest)(
        uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs), [(r.uid, r.status) for r in reqs]
    scores = eng.score(prompts[:2]) if score else None
    return [list(r.generated) for r in reqs], scores, eng.stats(reqs)


def _engine(arch, cls, table=True, **kw):
    jm, jp, jt, tm, tp, tt = _models(arch)
    kw.setdefault('max_slots', 2)
    if cls is JaxEngine:
        return JaxEngine(jm, jp, max_seq=MAX_SEQ,
                         precomputed=jt if table else None, **kw)
    return ServingEngine(tm, tp, max_seq=MAX_SEQ,
                         precomputed=tt if table else None, device='cpu',
                         **kw)


@pytest.mark.parametrize('arch', ARCHS)
def test_engine_matches_jax(arch):
    """3 requests on 2 slots (the third admitted into a reset slot), chunk
    4, the table: greedy tokens equal to JAX's dense engine's."""
    prompts = _prompts(3, (9, 14, 5))
    want, _, _ = _serve(_engine(arch, JaxEngine, chunk_size=4), prompts)
    got, _, _ = _serve(_engine(arch, ServingEngine, chunk_size=4), prompts)
    assert got == want


def test_xlstm_paged_matches_jax():
    """xlstm through the paged pool and the radix cache, page 8, a
    16-token shared prefix: the third request hits the first one's
    snapshot. Tokens and the pool's counters equal to JAX's."""
    prompts = _prompts(4, (3, 7, 5), prefix=_tokens(5, (16,)))
    kw = dict(chunk_size=4, prefix_cache=True, page_size=PS)
    want, _, ws = _serve(_engine('xlstm_125m', JaxEngine, **kw), prompts)
    got, _, gs = _serve(_engine('xlstm_125m', ServingEngine, **kw), prompts)
    assert got == want
    assert gs['prefix_hits'] >= 1
    for key in ('prefix_hits', 'prefix_misses', 'prefix_hit_tokens',
                'pages_in_use', 'evictions'):
        assert gs[key] == ws[key], key


@pytest.mark.parametrize('chunk', [1, 3, 8])
@pytest.mark.parametrize('arch', ARCHS)
def test_chunked_equals_token_by_token_bitwise(arch, chunk):
    """Chunked steps (``n_valid``; chunk 1 is the chunk path at T 1) give
    the one-token steps' hidden states and states bit for bit, with the
    table; the last chunk is ragged."""
    _, _, _, tm, tp, tt = _models(arch)
    M = tm.cfg.num_meta_tokens
    toks = _tokens()

    def run(ch):
        st = tm.make_states(B, MAX_SEQ, torch.float32, chunk=8,
                            device='cpu')
        if M:
            T.prime_meta_states(tp, st, tm.cfg, B)
        hs = []
        for p0, n in _decode_plan(ch or 1):
            tk = np.zeros((B, ch or 1), np.int32)
            tk[:, :n] = toks[:, p0:p0 + n]
            kw = {} if ch is None else dict(
                n_valid=torch.full((B,), n, dtype=torch.int32))
            h, st = tm.decode_step(tp, torch.from_numpy(tk), st,
                                   torch.full((B,), p0 + M,
                                              dtype=torch.int32),
                                   precomputed=tt, return_hidden=True,
                                   attn_backend='reference', **kw)
            hs.append(h[:, :n])
        return torch.cat(hs, dim=1), jax.tree_util.tree_leaves(st)

    h1, st1 = run(None)
    hc, stc = run(chunk)
    assert torch.equal(hc, h1)
    assert len(stc) == len(st1)
    assert all(torch.equal(a, b) for a, b in zip(stc, st1))


# (arch, paged) of the engines held against themselves
MODES = [('xlstm_125m', False), ('xlstm_125m', True), ('hymba_1_5b', False)]


@pytest.mark.parametrize('mode', ['packed', 'async'])
@pytest.mark.parametrize('arch,paged', MODES)
def test_packed_and_async_bitwise(arch, paged, mode):
    """Packed prefill against the unpacked engine, and the async loop
    against the synchronous one (both with packing in the async case):
    greedy tokens and ``score()`` logits bitwise; 5 requests on 3 slots,
    chunk 4."""
    prompts = _prompts(6, (9, 14, 5, 11, 3), prefix=_tokens(7, (8,)))
    kw = dict(max_slots=3, chunk_size=4)
    if paged:
        kw.update(prefix_cache=True, page_size=PS)
    extra = dict(pack_prefill=True) if mode == 'packed' \
        else dict(pack_prefill=True, async_loop=True)
    base_kw = {} if mode == 'packed' else dict(pack_prefill=True)
    _, _, _, tm, tp, tt = _models(arch)

    def engine(**more):
        return ServingEngine(tm, tp, max_seq=MAX_SEQ, precomputed=tt,
                             device='cpu', **kw, **more)
    want, wsc, _ = _serve(engine(**base_kw), prompts, score=True)
    got, gsc, _ = _serve(engine(**extra), prompts, score=True)
    assert got == want
    assert all(np.array_equal(a, b) for a, b in zip(gsc, wsc))


def _slstm_layers(states):
    """(state, slot axis) of every sLSTM layer of a states tree."""
    for part, st in states.items():
        for layer in (st if isinstance(st, list) else [st]):
            if 'h' in layer:
                yield layer, 1 if part == 'body' else 0


def test_slot_reset_copies_the_template():
    """One slot serves the same prompt twice: the same tokens (hymba: the
    primed meta state comes back). A reset copies the template's rows into
    the live leaves in place; xlstm's sLSTM ``n`` returns to ones, where a
    fill by leaf name would zero it."""
    p = _prompts(8, (10,))
    for arch in ARCHS:
        eng = _engine(arch, ServingEngine, chunk_size=4, max_slots=1)
        first, _, _ = _serve(eng, p)
        ptrs = [leaf.data_ptr() for leaf, _, _ in eng._reset_plan]
        assert _serve(eng, p)[0] == first, arch
        if arch == 'xlstm_125m':
            layers = list(_slstm_layers(eng.states))
            assert layers and not all(
                torch.all(st['n'].select(ax, 0) == 1) for st, ax in layers)
        eng._reset_slot(0)
        for (leaf, axis, fresh), ptr in zip(eng._reset_plan, ptrs):
            assert leaf.data_ptr() == ptr
            assert torch.equal(leaf.select(axis, 0), fresh.select(axis, 0))
        if arch == 'xlstm_125m':
            for st, ax in layers:
                assert torch.all(st['n'].select(ax, 0) == 1)
                assert torch.all(st['m'].select(ax, 0) == 0)


def test_paged_rules():
    """hymba refuses ``prefix_cache=True`` with JAX's ``ValueError``;
    xlstm's paged engine keeps no page leaves (no pool to clear, no job
    list to build, nothing fused), snapshots every per-slot leaf, and
    serves with the ``cuda`` backend's plumbing (plain versions on the
    CPU) exactly as with the reference backend."""
    with pytest.raises(ValueError, match='meta-token'):
        _engine('hymba_1_5b', ServingEngine, prefix_cache=True,
                page_size=PS)
    with pytest.raises(ValueError, match='meta-token'):
        _engine('hymba_1_5b', JaxEngine, prefix_cache=True, page_size=PS)
    prompts = _prompts(9, (3, 7, 5), prefix=_tokens(5, (16,)))
    runs = []
    for backend in ('reference', 'cuda'):
        eng = _engine('xlstm_125m', ServingEngine, chunk_size=4,
                      prefix_cache=True, page_size=PS, attn_backend=backend)
        assert eng._pools == [] and not eng._fused_maint
        assert not eng._lin_layers and not eng._ring_layers
        assert eng._needs_snapshot and eng._sc_ring == 0
        assert all(not pooled for _, _, pooled in eng._snap_plan)
        runs.append(_serve(eng, prompts)[0])
        assert eng.kv.hits >= 1
        snap = next(n.snapshot for n in _radix_nodes(eng.kv)
                    if n.snapshot is not None)
        assert len(snap) == len(eng._snap_plan)
    assert runs[0] == runs[1]


def _radix_nodes(kv):
    stack = [kv.root]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(node.children.values())


@pytest.mark.parametrize('argv', [
    ['--arch', 'xlstm-125m', '--prefix-cache', '--shared-prefix', '16',
     '--fused-gather-rope'],
    ['--arch', 'hymba-1.5b', '--chunk-size', '4', '--fused-gather-rope']])
def test_serve_cli(monkeypatch, capsys, argv):
    """The CLI serves both families (the fused gather falls back to the
    plain one: layer 0 is no attention layer); hymba with
    ``--prefix-cache`` raises JAX's ``ValueError``."""
    monkeypatch.setattr('sys.argv', ['serve', '--device', 'cpu',
                                     '--requests', '3', '--new-tokens', '3']
                        + argv)
    serve_cli.main()
    out = capsys.readouterr().out
    assert 'fused gather' not in out and 'tok/s' in out
    if 'hymba-1.5b' in argv:
        monkeypatch.setattr('sys.argv', ['serve', '--device', 'cpu',
                                         '--arch', 'hymba-1.5b',
                                         '--prefix-cache'])
        with pytest.raises(ValueError, match='meta-token'):
            serve_cli.main()
