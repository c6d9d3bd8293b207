"""The port's model (``repro_torch``) against the JAX package on the
mistral-7b smoke config in fp32, with the same (bridged) weights: decode
logits within the bound of ``tests/test_precompute_equivalence.py`` (atol
2e-4, rtol 2e-3) and cache positions exactly equal — one-token and chunked
steps, with and without the precomputed table, with the fused gather→RoPE,
through both attention backends (on the CPU the ``cuda`` backend's kernel
wrapper runs its plain version)."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.model import Model as JaxModel
from repro_torch import params as PR
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.model import Model

TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope='module')
def both():
    jcfg = jax_smoke_config('mistral_7b')
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config('mistral_7b'))
    tp = PR.from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
    return jm, jp, jm.build_table(jp), tm, tp, tm.build_table(tp)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_config_copy_matches_jax():
    from repro.configs import get_config as jax_config
    from repro_torch.configs import ALL_IDS
    assert ALL_IDS == ['mistral_7b', 'glm4_9b', 'deepseek_v2_lite_16b',
                       'pythia_6_9b', 'gemma3_1b', 'gemma3_27b',
                       'whisper_tiny', 'whisper_tiny_rope', 'internvl2_1b',
                       'mixtral_8x7b', 'mixtral_8x7b_parallel',
                       'llama3_405b', 'xlstm_125m', 'hymba_1_5b']
    # field by field, nested MLA / MoE configs included (the copies are
    # other classes, so compare their fields and class names)
    def fields(c):
        return {k: (type(v).__name__, dataclasses.asdict(v))
                if dataclasses.is_dataclass(v) else v
                for k, v in vars(c).items()}

    for name in ALL_IDS:
        assert get_config(name) == get_config(name)
        assert fields(get_config(name)) == fields(jax_config(name))
        assert fields(get_smoke_config(name)) == \
            fields(jax_smoke_config(name))


def test_init_params_tree_matches_jax_schema(both):
    jm, jp, _, tm, tp, _ = both
    ti = tm.init(seed=3, device='cpu')
    assert jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, jp)) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, ti))
    assert [a.shape for a in _leaves(jp)] == \
        [tuple(t.shape) for t in _leaves(ti)]
    # fan_in init over the stacked body shape: std 1/sqrt(reps * d_in)
    w = ti['backbone']['body'][0]['attn']['wq']['w']
    assert abs(float(w.std()) - (w.shape[0] * w.shape[1]) ** -0.5) < 0.1 \
        * (w.shape[0] * w.shape[1]) ** -0.5
    # the encoder families: the encoder-decoder (stacked encoder layers,
    # the biased proj_in, learned positions) and the VLM's projector
    for name in ('whisper_tiny', 'whisper_tiny_rope', 'internvl2_1b'):
        jtree = JaxModel(jax_smoke_config(name)).init(jax.random.PRNGKey(0))
        ttree = Model(get_smoke_config(name)).init(seed=3, device='cpu')
        assert jax.tree_util.tree_structure(
            jax.tree.map(lambda x: 0, jtree)) == \
            jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, ttree))
        assert [(a.shape, str(a.dtype)) for a in _leaves(jtree)] == \
            [(tuple(t.shape), str(t.dtype)[6:]) for t in _leaves(ttree)]
        # zeros-initialised biases, as JAX's
        b = ttree['encoder']['proj_in']['b'] if 'encoder' in ttree \
            else ttree['projector']['fc1']['b']
        assert not b.any()


def test_table_matches_jax(both):
    _, _, jt, _, _, tt = both
    assert tt.layout == jt.layout
    np.testing.assert_allclose(tt.table.numpy(), np.asarray(jt.table),
                               atol=1e-5, rtol=1e-5)


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        atol=2e-5, rtol=1e-5)
    s = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(s))),
        atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize('Sc,T,n_valid', [(11, 4, [4, 3, 0]),
                                          (5, 8, [8, 7, 2]),
                                          (3, 4, [1, 0, 4])])
def test_cache_update_chunk_matches_jax_bitwise(Sc, T, n_valid):
    """In-place ring writes == JAX's gather formulation, laps included."""
    rng = np.random.default_rng(Sc)
    B, KV, hd = 3, 2, 4
    cache = {'k': rng.standard_normal((B, Sc, KV, hd)).astype(np.float32),
             'v': rng.standard_normal((B, Sc, KV, hd)).astype(np.float32),
             'pos': rng.integers(-1, 9, (B, Sc)).astype(np.int32)}
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    pos0 = np.array([9, 2, 17], np.int32)
    nv = np.array(n_valid, np.int32)
    want = JA.cache_update_chunk({n: jnp.asarray(a) for n, a in cache.items()},
                                 jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos0), jnp.asarray(nv))
    got = A.cache_update_chunk(
        {n: torch.from_numpy(a.copy()) for n, a in cache.items()},
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos0),
        torch.from_numpy(nv))
    for n in cache:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def _stream(chunk):
    B, S = 3, 40
    toks = np.random.default_rng(7).integers(0, 503, (B, S)).astype(np.int32)
    nv = np.array([chunk, max(chunk - 1, 1), 0 if chunk > 1 else 1],
                  np.int32)
    return toks, nv


def _pos_leaves(states):
    out = [states['layer0']['pos'], states['body'][0]['pos']]
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
            for x in out]


@pytest.fixture(scope='module')
def jax_runs(both):
    """JAX logits and cache positions per (chunk, table, fused) run, made
    once and shared by both port backends."""
    jm, jp, jt, _, _, _ = both
    memo = {}

    def get(chunk, table, fused, n_steps):
        key = (chunk, table, fused, n_steps)
        if key not in memo:
            toks, nv = _stream(chunk)
            B = toks.shape[0]
            st = jm.make_states(B, toks.shape[1], jnp.float32, chunk=chunk)
            pos = np.zeros(B, np.int32)
            steps = []
            kw = dict(n_valid=jnp.asarray(nv), fused_gather_rope=fused) \
                if chunk > 1 else {}
            step = jax.jit(lambda p, tk, st, ps: jm.decode_step(
                p, tk, st, ps, precomputed=jt if table else None,
                attn_backend='reference', **kw))
            for _ in range(n_steps):
                tk = np.stack([toks[b, pos[b]:pos[b] + chunk]
                               for b in range(B)])
                lg, st = step(jp, jnp.asarray(tk), st, jnp.asarray(pos))
                steps.append((np.asarray(lg), _pos_leaves(st)))
                pos = pos + (nv if chunk > 1 else 1)
            memo[key] = steps
        return memo[key]
    return get


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
@pytest.mark.parametrize('chunk,table,fused', [(1, False, False),
                                               (1, True, False),
                                               (4, False, False),
                                               (4, True, False),
                                               (4, True, True)])
def test_decode_matches_jax(both, jax_runs, chunk, table, fused, backend):
    """Logits of the valid lanes and every cache pos leaf after each step,
    over enough steps to wrap the smoke config's ring (window 8)."""
    _, _, _, tm, tp, tt = both
    n_steps = 12 if chunk == 1 else 5
    toks, nv = _stream(chunk)
    B = toks.shape[0]
    st = tm.make_states(B, toks.shape[1], torch.float32, chunk=chunk,
                        device='cpu')
    pos = np.zeros(B, np.int32)
    for jl, jpos in jax_runs(chunk, table, fused, n_steps):
        tk = np.stack([toks[b, pos[b]:pos[b] + chunk] for b in range(B)])
        kw = dict(n_valid=torch.from_numpy(nv), fused_gather_rope=fused) \
            if chunk > 1 else {}
        tl, st = tm.decode_step(tp, torch.from_numpy(tk), st,
                                torch.from_numpy(pos),
                                precomputed=tt if table else None,
                                attn_backend=backend, **kw)
        for b in range(B):
            n = int(nv[b]) if chunk > 1 else 1
            np.testing.assert_allclose(tl[b, :n].numpy(), jl[b, :n], **TOL)
        for got, want in zip(_pos_leaves(st), jpos):
            np.testing.assert_array_equal(got, want)
        pos = pos + (nv if chunk > 1 else 1)


def test_unported_families_raise():
    """What is still unported raises: the parallel block with MLA
    attention (no config has one), and a mesh engine with a recurrent or
    meta-token model (ROADMAP A.5). The recurrent and hybrid families are
    ported (``tests/test_torch_recurrent.py``)."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.engine import ServingEngine
    mla = dataclasses.replace(get_smoke_config('deepseek_v2_lite_16b'),
                              block_type='parallel')
    with pytest.raises(NotImplementedError):
        Model(mla).make_states(1, 8, device='cpu')
    for name in ('xlstm_125m', 'hymba_1_5b'):
        m = Model(get_config(name))
        assert m.cfg.arch_class in ('ssm', 'hybrid')
        sm = Model(get_smoke_config(name))
        sp = sm.init(0, device='cpu', dtype=torch.float32)
        with pytest.raises(NotImplementedError, match='A.5'):
            ServingEngine(sm, sp, prefix_cache=True, page_size=8,
                          max_seq=64, device='cpu',
                          mesh=make_serving_mesh('2x2', devices=['cpu'] * 4))


@pytest.fixture(scope='module')
def learned():
    """mistral-7b's smoke config with learned absolute positions in place
    of RoPE: a decoder-only model that takes ``pos_embed`` (no config of
    the repo is one; whisper's decoder embeds through ``encdec``), on one
    set of weights in both packages."""
    kw = dict(pos='learned', precompute_supported=False)
    jm = JaxModel(dataclasses.replace(jax_smoke_config('mistral_7b'), **kw))
    jp = jm.init(jax.random.PRNGKey(3))
    tm = Model(dataclasses.replace(get_smoke_config('mistral_7b'), **kw))
    tp = PR.from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
    return jm, jp, tm, tp


@pytest.mark.parametrize('chunk', [0, 1, 4])
def test_learned_positions_decoder_matches_jax(learned, chunk):
    """``lm_schema``'s ``pos_embed`` and ``embed_tokens(positions)``: the
    full forward (chunk 0), the one-token step (each lane at pos) and the
    chunked step (lane t at pos + t) within TOL of JAX's, 5 steps; the
    table is refused, as JAX refuses it."""
    jm, jp, tm, tp = learned
    assert tp['pos_embed'].shape == (tm.cfg.max_seq_len, tm.cfg.d_model)
    with pytest.raises(AssertionError):
        tm.build_table(tp)
    toks, nv = _stream(max(chunk, 1))
    B = toks.shape[0]
    if chunk == 0:
        jl, _ = jm.apply(jp, {'tokens': jnp.asarray(toks[:, :16])})
        tl, _ = tm.apply(tp, {'tokens': torch.from_numpy(toks[:, :16])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        return
    jst = jm.make_states(B, toks.shape[1], jnp.float32, chunk=chunk)
    st = tm.make_states(B, toks.shape[1], torch.float32, chunk=chunk,
                        device='cpu')
    pos = np.zeros(B, np.int32)
    for _ in range(5):
        tk = np.stack([toks[b, pos[b]:pos[b] + chunk] for b in range(B)])
        jkw = dict(n_valid=jnp.asarray(nv)) if chunk > 1 else {}
        tkw = dict(n_valid=torch.from_numpy(nv)) if chunk > 1 else {}
        jl, jst = jm.decode_step(jp, jnp.asarray(tk), jst, jnp.asarray(pos),
                                 attn_backend='reference', **jkw)
        tl, st = tm.decode_step(tp, torch.from_numpy(tk), st,
                                torch.from_numpy(pos), **tkw)
        for b in range(B):
            n = int(nv[b]) if chunk > 1 else 1
            np.testing.assert_allclose(tl[b, :n].numpy(),
                                       np.asarray(jl)[b, :n], **TOL)
        pos = pos + (nv if chunk > 1 else 1)
