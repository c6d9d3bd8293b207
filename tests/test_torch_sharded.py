"""The port's sharded serving over a ``('pool', 'heads')`` mesh against the
JAX package.

The mesh is emulated on the CPU by repeating one device (``['cpu'] * 4``),
as the JAX tests emulate 4 CPU devices; no JAX mesh and no ``XLA_FLAGS``
are needed, because JAX's own suite pins its mesh engine bitwise to its
unsharded engine, so the port's mesh engine is held against JAX's
unsharded one. Tolerances, each with its reason:

- ``make_serving_mesh``: the same ``ValueError`` messages as JAX for the
  same malformed specs; too few devices names ``devices=`` (JAX names
  ``XLA_FLAGS``).
- ``partition_pages`` and the layout rules (``sharding.leaf_axes`` /
  ``spec_for_shape`` against the JAX engine's ``_leaf_axes`` and
  ``serving_rules(mesh).spec_for_shape``): exactly equal.
- ``sharded_paged_attention``: **bitwise** equal to one unsharded call
  (every kv head's softmax is independent), and within atol 2e-4 / rtol
  2e-3 of JAX's ``paged_attention`` in interpret mode (the plain version's
  fp32 sums are in another order).
- Engine: greedy tokens of the mesh engine (``'2x2'`` and ``'1x2'``) equal,
  bitwise, the port's unsharded engine's and JAX's unsharded engine's on the
  same weights, in fp32 and int8, GQA and MLA (which falls back to the
  one-device attend), through prefix hits and preemptions.

On the CPU the ``cuda`` backend's kernel wrappers run their plain versions,
so the mesh engine with ``attn_backend='cuda'`` runs every shard's attend
through ``sharded_paged_attention``. The ``cuda``-marked twins of the kernel
checks are in ``tests/test_torch_kernels.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.config import MLAConfig as JaxMLAConfig
from repro.config import ModelConfig as JaxModelConfig
from repro.kernels import paged_attention as JPA
from repro.launch.mesh import make_serving_mesh as jax_make_serving_mesh
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.engine import RequestStatus as JaxRequestStatus
from repro.serving.kvpool import partition_pages as jax_partition_pages
from repro.sharding import serving_rules as jax_serving_rules
from repro_torch.config import MLAConfig, ModelConfig
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_plain,
                                                 paged_attention_quant,
                                                 sharded_paged_attention,
                                                 sharded_paged_attention_plain)
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, RequestStatus, ServingEngine
from repro_torch.serving.kvpool import partition_pages
from repro_torch.sharding import (ShardedLeaf, gather_leaf, leaf_axes,
                                  shard_leaf, spec_for_shape)

PS = 8
MAX_SEQ = 64
JAX_TOL = dict(atol=2e-4, rtol=2e-3)
CPU4 = ['cpu'] * 4


def cpu_mesh(spec):
    return make_serving_mesh(spec, devices=CPU4)


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize('bad', ['nonsense', '2x2x2', '2x', 'x2', '0x2',
                                 '2x-1', (2,), '64x64'])
def test_mesh_spec_valueerror_like_jax(bad):
    """Impossible shapes are user input: ValueError, with JAX's message
    for every malformed spec; too many devices names ``devices=`` where
    JAX names its CPU-emulation flag."""
    with pytest.raises(ValueError) as got:
        make_serving_mesh(bad)
    with pytest.raises(ValueError) as want:
        jax_make_serving_mesh(bad)
    if bad == '64x64':
        assert 'devices=' in str(got.value)
        assert 'needs 4096 devices' in str(got.value)
        assert 'xla_force_host_platform' in str(want.value)
    else:
        assert str(got.value) == str(want.value)


def test_mesh_grid_devices_and_trivial_specs():
    for trivial in (None, '', '1x1', (1, 1)):
        assert make_serving_mesh(trivial) is None
        assert jax_make_serving_mesh(trivial) is None
    mesh = make_serving_mesh('2×2', devices=CPU4)
    assert mesh.shape == (2, 2) and mesh.sizes == {'pool': 2, 'heads': 2}
    assert mesh.primary == torch.device('cpu')
    assert make_serving_mesh(mesh) is mesh
    assert make_serving_mesh((1, 2), devices=CPU4).devices == \
        ((torch.device('cpu'),) * 2,)
    if not torch.cuda.is_available():     # no device is repeated unasked
        with pytest.raises(ValueError, match='devices='):
            make_serving_mesh('1x2')
    with pytest.raises(ValueError, match='grid'):
        ServingMesh((2, 2), ((torch.device('cpu'),) * 2,))


def test_mesh_rejects_mixed_device_types():
    """A grid mixing device types is refused where it is built, so no
    shard of a card's tensors runs quietly on the CPU; the sharded attend
    refuses a mesh of another device type than its queries'."""
    with pytest.raises(ValueError, match='one type'):
        make_serving_mesh('1x2', devices=['meta', 'cpu'])
    with pytest.raises(ValueError, match='one type'):
        ServingMesh((1, 2), ((torch.device('meta'), torch.device('cpu')),))
    q = torch.zeros((1, 1, 2, 1, 4), device='meta')
    pages = torch.zeros((2, PS, 2, 4), device='meta')
    pos = torch.zeros((2, PS), dtype=torch.int32, device='meta')
    table = torch.zeros((1, 2), dtype=torch.int32, device='meta')
    pos0 = torch.zeros((1,), dtype=torch.int32, device='meta')
    for fn in (sharded_paged_attention, sharded_paged_attention_plain):
        with pytest.raises(ValueError, match='mesh devices are cpu'):
            fn(q, pages, pages, pos, table, pos0, mesh=cpu_mesh('1x2'),
               scale=0.5)


# ---------------------------------------------------------- partitioning
def test_partition_pages_examples():
    assert partition_pages(8, 2) == [range(0, 4), range(4, 8)]
    assert partition_pages(6, 1) == [range(0, 6)]
    for bad in ((8, 0), (10, 4)):
        with pytest.raises(ValueError) as got:
            partition_pages(*bad)
        with pytest.raises(ValueError) as want:
            jax_partition_pages(*bad)
        assert str(got.value) == str(want.value)


@settings(max_examples=50, deadline=None)
@given(shards=st.integers(1, 8), per=st.integers(1, 64))
def test_partition_pages_is_bijection_like_jax(shards, per):
    num_pages = shards * per
    parts = partition_pages(num_pages, shards)
    assert parts == jax_partition_pages(num_pages, shards)
    seen = [p for part in parts for p in part]
    assert sorted(seen) == list(range(num_pages)) == list(seen)


# (name, shape, stacked, pooled): the leaves of paged GQA / int8 / MLA
# pools, unstacked and stacked over 3 layers, divisible and not, and
# per-slot leaves (batch axis)
LAYOUT_CASES = [
    ('k', (80, 8, 4, 16), False, True), ('pos', (80, 8), False, True),
    ('v', (3, 80, 8, 4, 16), True, True), ('pos', (3, 80, 8), True, True),
    ('k_scale', (81, 8, 4), False, True), ('v_scale', (3, 80, 8, 2), True,
                                           True),
    ('k', (81, 8, 3, 16), False, True), ('ckv', (3, 80, 8, 16), True, True),
    ('k', (4, 64, 4, 16), False, False), ('k', (3, 3, 64, 4, 16), True,
                                          False),
    ('pos', (4, 64), False, False), ('k', (8,), False, True),
]


@pytest.mark.parametrize('P,H', [(2, 2), (1, 2), (4, 1)])
def test_layout_rules_match_jax(P, H):
    """The per-leaf logical axes and the divisibility fallback equal JAX's
    ``_leaf_axes`` and ``serving_rules(mesh).spec_for_shape`` (a duck-typed
    mesh: the rules read only its axis names and device grid shape)."""
    jmesh = types.SimpleNamespace(axis_names=('pool', 'heads'),
                                  devices=np.empty((P, H)))
    rules = jax_serving_rules(jmesh)
    mesh = make_serving_mesh((P, H), devices=CPU4)
    DK, SK = jax.tree_util.DictKey, jax.tree_util.SequenceKey
    for name, shape, stacked, pooled in LAYOUT_CASES:
        path = (DK('body'), SK(0), DK(name)) if stacked \
            else (DK('layer0'), DK(name))
        leaf = np.empty(shape)
        want_axes = JaxEngine._leaf_axes(None, path, leaf, pooled)
        axes = leaf_axes(name, len(shape), stacked, pooled)
        assert axes == want_axes, (name, shape)
        want = tuple(rules.spec_for_shape(shape, want_axes))
        want += (None,) * (len(shape) - len(want))
        assert spec_for_shape(mesh, shape, axes) == want, (name, shape)


def test_shard_and_gather_leaf():
    """Blocks are contiguous tensors of their own holding pages
    ``partition_pages(NP, P)[i]`` and kv heads ``h``; a replicated
    dimension is whole in every block; gathering gives the leaf back."""
    mesh = cpu_mesh('2x2')
    x = torch.randn(3, 80, 8, 4, 16)
    spec = (None, 'pool', None, 'heads', None)
    leaf = shard_leaf(x, spec, mesh)
    parts = partition_pages(80, 2)
    for i in range(2):
        for h in range(2):
            b = leaf.blocks[i][h]
            assert b.is_contiguous() and b.untyped_storage().data_ptr() \
                != x.untyped_storage().data_ptr()
            assert torch.equal(b, x[:, parts[i].start:parts[i].stop, :,
                                    2 * h:2 * h + 2])
    assert torch.equal(gather_leaf(leaf, torch.device('cpu')), x)
    rep = shard_leaf(x[0], (None, None, None, None), mesh)
    assert all(torch.equal(b, x[0]) for row in rep.blocks for b in row)
    assert torch.equal(gather_leaf(rep, torch.device('cpu')), x[0])


# ------------------------------------------------- sharded_paged_attention
def _pages_case(seed, B, T, KV, G, d, NP, ps, lengths):
    """A pool with slots' pages drawn at random from [1, NP) (a scattered
    table), slot b holding positions [0, lengths[b]); page 0 is null."""
    rng = np.random.default_rng(seed)
    P = MAX_SEQ // ps
    table = (rng.permutation(NP - 1)[:B * P] + 1).reshape(B, P) \
        .astype(np.int32)
    cpos = np.full((NP, ps), -1, np.int32)
    for b, n in enumerate(lengths):
        table[b, -(-n // ps):] = 0
        for p in range(n):
            cpos[table[b, p // ps], p % ps] = p
    k = rng.standard_normal((NP, ps, KV, d)).astype(np.float32)
    v = rng.standard_normal((NP, ps, KV, d)).astype(np.float32)
    k[0] = v[0] = 0.0
    q = rng.standard_normal((B, T, KV, G, d)).astype(np.float32)
    pos0 = np.array([max(n - T, 0) for n in lengths], np.int32)
    return q, k, v, cpos, table, pos0


def _int8(x, seed):
    """int8 values and bf16-exact scales (so JAX and the port read the same
    numbers) in the int8 cache's layout."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-127, 128, x.shape).astype(np.int8)
    scale = (rng.integers(1, 64, x.shape[:-1]) / 512.).astype(np.float32)
    return vals, scale


@pytest.mark.parametrize('H', [2, 4])
@pytest.mark.parametrize('form', ['float32', 'bfloat16', 'int8'])
def test_sharded_paged_attention_bitwise_and_like_jax(form, H):
    """KV 4, G 2 through a scattered table, T 3, a window on the fp32
    case: the split over H head shards on ``['cpu'] * H`` is bitwise one
    unsharded call (and its plain version), and agrees with JAX's kernel
    in interpret mode; no launch is counted on the CPU."""
    q, k, v, cpos, table, pos0 = _pages_case(H, 3, 3, 4, 2, 16, 30, PS,
                                             [37, 9, 0])
    mesh = make_serving_mesh((1, H), devices=CPU4)
    window = 11 if form == 'float32' else 0
    kw = dict(scale=16 ** -0.5, window=window)
    jkw = dict(kw)
    if form == 'int8':
        (k, ks), (v, vs) = _int8(k, 1), _int8(v, 2)
        jkw.update(k_scale_pages=jnp.asarray(ks, jnp.bfloat16),
                   v_scale_pages=jnp.asarray(vs, jnp.bfloat16))
        kw.update(k_scale_pages=torch.from_numpy(ks).bfloat16(),
                  v_scale_pages=torch.from_numpy(vs).bfloat16())
    tdt = torch.bfloat16 if form == 'bfloat16' else torch.float32
    args = [torch.from_numpy(a) for a in (q, k, v, cpos, table, pos0)]
    args = [a.to(tdt) if a.is_floating_point() else a for a in args]
    n0 = (sharded_paged_attention.launches, paged_attention.launches,
          paged_attention_quant.launches)
    got = sharded_paged_attention(*args, mesh=mesh, **kw)
    if form == 'int8':
        one = paged_attention_quant(*args[:3], kw['k_scale_pages'],
                                    kw['v_scale_pages'], *args[3:],
                                    scale=kw['scale'], window=window)
    else:
        one = paged_attention(*args, **kw)
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    assert torch.equal(got, one)
    assert torch.equal(sharded_paged_attention_plain(*args, mesh=mesh, **kw),
                       one)
    assert (sharded_paged_attention.launches, paged_attention.launches,
            paged_attention_quant.launches) == n0
    jdt = jnp.bfloat16 if form == 'bfloat16' else jnp.float32
    jargs = [jnp.asarray(a) for a in (q, k, v, cpos, table, pos0)]
    jargs = [a.astype(jdt) if a.dtype == jnp.float32 else a for a in jargs]
    want = JPA.paged_attention(*jargs, **jkw, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **JAX_TOL)
    assert not got[2].any()


@pytest.mark.parametrize('case', ['no_mesh', 'one_head_shard', 'kv_odd',
                                  'mla'])
def test_sharded_paged_attention_falls_back(case, monkeypatch):
    """No mesh, a heads axis of 1, kv heads the axis does not divide, MLA:
    one unsharded call on the whole input, as JAX falls back."""
    calls = []
    real = PA.paged_attention

    def spy(q, *a, **kw):
        calls.append(q.shape)
        return real(q, *a, **kw)
    monkeypatch.setattr(PA, 'paged_attention', spy)
    KV = 3 if case == 'kv_odd' else 4
    mesh = {'no_mesh': None, 'one_head_shard': cpu_mesh('4x1')}.get(
        case, cpu_mesh('2x2'))
    q, k, v, cpos, table, pos0 = map(torch.from_numpy, _pages_case(
        5, 2, 2, KV, 2, 16, 20, PS, [21, 6]))
    kw = dict(scale=0.25)
    if case == 'mla':
        r = 12
        q = torch.randn(2, 2, 1, 4, 16)
        k, k2 = k[:, :, :1, :r].contiguous(), k[:, :, :1, r:].contiguous()
        kw.update(k2_pages=k2, mla_split=r)
        v = None
    got = sharded_paged_attention(q, k, v, cpos, table, pos0, mesh=mesh,
                                  **kw)
    assert calls == [q.shape]
    assert torch.equal(got, real(q, k, v, cpos, table, pos0, **kw))
    assert torch.equal(sharded_paged_attention_plain(
        q, k, v, cpos, table, pos0, mesh=mesh, **kw), got)


# ----------------------------------------------------------------- engine
def _cfg_kw(kind):
    base = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                head_dim=16, d_ff=128, vocab_size=211, max_seq_len=256,
                dtype='float32', arch_class='dense')
    if kind == 'gqa':
        return dict(name='sh-gqa', **base), None
    return dict(name='sh-mla', tie_embeddings=False, **base), \
        dict(kv_lora_rank=16, q_lora_rank=0, qk_nope_dim=16, qk_rope_dim=8,
             v_head_dim=16)


_BUILT = {}


def _build(kind):
    """(JAX model, JAX params, port model, the same params in torch): the
    ``sh-gqa`` / ``sh-mla`` configs of ``tests/test_sharded_serving.py``."""
    if kind not in _BUILT:
        kw, mla = _cfg_kw(kind)
        jm = JaxModel(JaxModelConfig(
            mla=JaxMLAConfig(**mla) if mla else None, **kw))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = Model(ModelConfig(mla=MLAConfig(**mla) if mla else None, **kw))
        tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
        _BUILT[kind] = (jm, jp, tm, tp)
    return _BUILT[kind]


def _waves(req_cls):
    """Two request waves sharing a 20-token prefix; wave 2 hits the radix
    (``tests/test_sharded_serving.py``'s waves)."""
    prefix = np.random.default_rng(99).integers(3, 200, size=20)
    return [[req_cls(uid=s, prompt=np.concatenate([
        prefix, np.random.default_rng(s).integers(3, 200, size=4)]),
        max_new_tokens=5) for s in seeds] for seeds in ([7, 8, 9], [50, 51])]


def _serve_waves(eng, req_cls, finished):
    out = []
    for reqs in _waves(req_cls):
        for r in reqs:
            eng.submit(r)
        eng.run()
        out += reqs
    assert all(r.status is finished for r in out)
    return [r.generated for r in out]


_JAX_TOKENS = {}


def _jax_tokens(kind, quant):
    """JAX's unsharded paged engine, made once per (kind, quant)."""
    if (kind, quant) not in _JAX_TOKENS:
        jm, jp, _, _ = _build(kind)
        eng = JaxEngine(jm, jp, max_slots=2, max_seq=MAX_SEQ, chunk_size=4,
                        prefix_cache=True, page_size=PS, kv_quant=quant)
        _JAX_TOKENS[kind, quant] = _serve_waves(eng, JaxRequest,
                                                JaxRequestStatus.FINISHED)
    return _JAX_TOKENS[kind, quant]


def _port_engine(kind, **kw):
    _, _, tm, tp = _build(kind)
    return ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ, chunk_size=4,
                         prefix_cache=True, page_size=PS, device='cpu', **kw)


@pytest.mark.parametrize('spec', ['2x2', '1x2'])
@pytest.mark.parametrize('kind,quant', [('gqa', False), ('gqa', True),
                                        ('mla', False)])
def test_mesh_engine_tokens_bitwise(kind, quant, spec):
    """Greedy tokens of the mesh engine (``cuda`` backend: the sharded
    attend, plain versions here) equal the port's unsharded engine's and
    JAX's unsharded engine's on the same weights, cold and on prefix
    hits."""
    want = _serve_waves(_port_engine(kind, kv_quant=quant,
                                     attn_backend='cuda'),
                        Request, RequestStatus.FINISHED)
    eng = _port_engine(kind, kv_quant=quant, attn_backend='cuda',
                       mesh=cpu_mesh(spec))
    assert eng.attn_backend.name == 'cuda'
    assert eng.attn_backend.mesh is eng.mesh   # the sharded attend
    assert eng._fused_maint                # kept on under the mesh
    got = _serve_waves(eng, Request, RequestStatus.FINISHED)
    assert got == want
    assert eng.kv.hits > 0
    assert got == _jax_tokens(kind, quant)


@pytest.mark.parametrize('num_pages', [80, 81])
def test_state_at_rest_in_blocks(num_pages):
    """After ``run()`` every pool leaf is a grid of blocks on the mesh's
    devices: pages ``partition_pages(NP, 2)[i]`` (or all of them when 2
    does not divide NP) and kv heads ``2h:2h+2`` of the gathered leaf."""
    mesh = cpu_mesh('2x2')
    eng = _port_engine('gqa', kv_quant=True, attn_backend='cuda', mesh=mesh,
                       num_pages=num_pages)
    _serve_waves(eng, Request, RequestStatus.FINISHED)
    assert eng._pools is None and eng._reset_plan is None
    full = eng._rep_in(eng.states)
    parts = partition_pages(80, 2) if num_pages == 80 \
        else [range(num_pages)] * 2
    n = 0
    for part, st in eng.states.items():
        for li, layer in enumerate(st if isinstance(st, list) else [st]):
            lead = 1 if part == 'body' else 0
            for nm, leaf in layer.items():
                assert isinstance(leaf, ShardedLeaf)
                x = full[part][li][nm] if isinstance(st, list) \
                    else full[part][nm]
                heads = {'k': -2, 'v': -2, 'k_scale': -1,
                         'v_scale': -1}.get(nm)
                for i in range(2):
                    for h in range(2):
                        b = leaf.blocks[i][h]
                        assert b.device == mesh.devices[i][h]
                        want = x.narrow(lead, parts[i].start,
                                        len(parts[i]))
                        if heads is not None:
                            want = want.narrow(x.dim() + heads, 2 * h, 2)
                        assert torch.equal(b, want), (nm, i, h)
                        n += 1
    assert n == 5 * 4 * 2                  # 5 leaves, 2 layers, 4 blocks


@pytest.mark.parametrize('kv_quant', [False, True])
def test_preempt_resume_under_mesh_matches_dense(kv_quant):
    """An 8-page pool (4 pages on each pool shard) cannot hold both slots:
    a preemption happens under ``'2x2'`` and every request's tokens equal
    the dense engine's."""
    _, _, tm, tp = _build('gqa')
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 200, size=k).astype(np.int32)
               for k in (28, 23, 17, 25)]

    def serve(eng):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        report = eng.run(max_iters=5000)
        assert report['stalled'] == 0 and report['in_flight'] == 0
        assert all(r.status is RequestStatus.FINISHED for r in reqs)
        return [r.generated for r in reqs], report['preemptions']

    want, _ = serve(ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ,
                                  chunk_size=4, kv_quant=kv_quant,
                                  device='cpu'))
    got, pre = serve(_port_engine('gqa', attn_backend='cuda', num_pages=8,
                                  kv_quant=kv_quant, mesh=cpu_mesh('2x2')))
    assert pre > 0
    assert got == want


def test_mesh_engine_score_and_reference_backend():
    """Scoring under the mesh gives the unsharded engine's logits bitwise;
    the reference backend stays as it is (with eager page clears)."""
    prompts = [np.arange(3, 3 + n, dtype=np.int32) for n in (13, 21)]
    eng = _port_engine('gqa', mesh=cpu_mesh('2x2'))
    assert eng.attn_backend.name == 'reference' and not eng._fused_maint
    got = eng.score(prompts)
    want = _port_engine('gqa').score(prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert isinstance(eng.states['layer0']['k'], ShardedLeaf)


def test_mesh_engine_validation():
    _, _, tm, tp = _build('gqa')
    with pytest.raises(NotImplementedError, match='dense engine under a '
                                                  'mesh'):
        ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ, device='cpu',
                      mesh=cpu_mesh('2x2'))
    with pytest.raises(ValueError, match='primary device'):
        _port_engine('gqa', mesh=make_serving_mesh(
            '1x2', devices=[torch.device('meta')] * 2))
    with pytest.raises(ValueError):
        _port_engine('gqa', mesh='64x64')
    assert _port_engine('gqa', mesh='1x1').mesh is None


def test_serve_cli_mesh_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr('sys.argv', [
        'serve', '--device', 'cpu', '--arch', 'glm4-9b', '--requests', '3',
        '--new-tokens', '3', '--chunk-size', '4', '--prefix-cache',
        '--page-size', '8', '--shared-prefix', '16', '--mesh', '2x2',
        '--attn-backend', 'cuda'])
    serve.main()
    out = capsys.readouterr().out
    assert 'serving mesh: 2x2 (pool x heads) over 4 devices' in out
    assert '3 requests, 9 new tokens' in out
