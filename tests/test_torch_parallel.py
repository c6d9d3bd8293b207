"""The parallel block (pythia-6.9b: LayerNorm, MHA, a GELU MLP, untied head)
in the port (``repro_torch``) against the JAX package, on the pythia-6.9b
smoke config in fp32 with the same (bridged) weights (``PRNGKey(0)``):
logits within the bound of ``tests/test_precompute_equivalence.py`` (atol
2e-4, rtol 2e-3) and cache positions exactly equal.

- ``layernorm`` against JAX's, and the parameter tree (the norms' ``bias``
  leaves included) against JAX's schema.
- The precomputed table (rows ``[s, q, k, v]``, ``s = x + FFN(LN2(x))``)
  and its layout against ``JaxModel.build_table``.
- Decode logits over one-token and chunked steps, with and without the
  table, with the fused gather-RoPE, through both attention backends (on
  the CPU the ``cuda`` backend's kernel wrappers run their plain versions).
- ``Model.apply``, baseline and with the table, at S 16 and at S 2048 (the
  blocked core), and baseline against the table inside the port.
- The paged engine with the radix cache: greedy tokens and prefix hits
  through a copy-on-write equal the JAX paged engine's.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, RequestStatus, ServingEngine

ARCH = 'pythia_6_9b'
TOL = dict(atol=2e-4, rtol=2e-3)
_MEMO = {}


@pytest.fixture(scope='module')
def both():
    """(JAX model, JAX params, JAX table, port model, port params, port
    table) on one set of weights."""
    jm = JaxModel(jax_smoke_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config(ARCH))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
    return jm, jp, jm.build_table(jp), tm, tp, tm.build_table(tp)


# -------------------------------------------------------- norm and params
def test_layernorm_matches_jax():
    """fp32 and bf16 inputs (fp32 inside, cast back), eps 1e-5, and the
    schema's leaves in JAX's order."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(JL.layernorm(*map(jnp.asarray, (x, s, b))))
    got = L.layernorm(*map(torch.from_numpy, (x, s, b)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(
        L.norm_apply({'scale': torch.from_numpy(s),
                      'bias': torch.from_numpy(b)},
                     torch.from_numpy(x), 'layernorm').numpy(), want,
        atol=2e-6, rtol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got_b = L.layernorm(xb, torch.from_numpy(s), torch.from_numpy(b))
    want_b = JL.layernorm(jnp.asarray(x).astype(jnp.bfloat16),
                          jnp.asarray(s), jnp.asarray(b))
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(),
                               np.asarray(want_b.astype(jnp.float32)),
                               atol=0.05, rtol=0.01)
    assert list(L.norm_schema(64, 'layernorm')) == \
        list(JL.norm_schema(64, 'layernorm')) == ['scale', 'bias']
    assert {k: v.shape for k, v in L.norm_schema(64, 'layernorm').items()} \
        == {k: v.shape for k, v in JL.norm_schema(64, 'layernorm').items()}


def test_params_tree_matches_jax(both):
    """The bridged tree and the port's own init have JAX's structure and
    shapes, LayerNorm biases included (zeros at init)."""
    _, jp, _, tm, tp, _ = both
    ti = tm.init(seed=3, device='cpu')

    def structure(tree):
        return jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, tree))
    for tree in (tp, ti):
        assert structure(tree) == structure(jp)
        assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(tree)] \
            == [a.shape for a in jax.tree_util.tree_leaves(jp)]
    lay0 = ti['backbone']['layer0']
    for nm in ('ln1', 'ln2'):
        assert list(lay0[nm]) == ['scale', 'bias']
        assert not lay0[nm]['bias'].any() and bool((lay0[nm]['scale']
                                                    == 1).all())
    assert not ti['final_norm']['bias'].any()
    assert 'w_gate' not in lay0['ffn'] and 'lm_head' in ti


def test_table_matches_jax(both):
    _, _, jt, tm, _, tt = both
    cfg = tm.cfg
    assert tt.layout == jt.layout == (
        ('s', cfg.d_model), ('q', cfg.q_size), ('k', cfg.kv_size),
        ('v', cfg.kv_size))
    assert tt.table.shape == (cfg.vocab_size, cfg.precompute_row_width)
    np.testing.assert_allclose(tt.table.numpy(), np.asarray(jt.table), **TOL)


# ------------------------------------------------------------------ decode
DECODE_RUNS = ((1, False, False), (1, True, False), (4, False, False),
               (4, True, False), (4, True, True))


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


def _jax_decode(both, chunk, table, fused, n_steps):
    """JAX logits and cache positions after each step, made once per run
    and shared by both port backends."""
    key = ('decode', chunk, table, fused, n_steps)
    if key not in _MEMO:
        jm, jp, jt = both[:3]
        toks, nv = _stream(chunk)
        B = toks.shape[0]
        st = jm.make_states(B, toks.shape[1], jnp.float32, chunk=chunk)
        pos = np.zeros(B, np.int32)
        kw = dict(n_valid=jnp.asarray(nv), fused_gather_rope=fused) \
            if chunk > 1 else {}
        step = jax.jit(lambda p, tk, st, ps: jm.decode_step(
            p, tk, st, ps, precomputed=jt if table else None,
            attn_backend='reference', **kw))
        steps = []
        for _ in range(n_steps):
            tk = np.stack([toks[b, pos[b]:pos[b] + chunk] for b in range(B)])
            lg, st = step(jp, jnp.asarray(tk), st, jnp.asarray(pos))
            steps.append((np.asarray(lg), _pos_leaves(st)))
            pos = pos + (nv if chunk > 1 else 1)
        _MEMO[key] = steps
    return _MEMO[key]


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
def test_decode_matches_jax(both, backend):
    """Every (chunk, table, fused) run of ``DECODE_RUNS``: logits of the
    valid lanes and every cache position leaf after each step."""
    _, _, _, tm, tp, tt = both
    for chunk, table, fused in DECODE_RUNS:
        n_steps = 10 if chunk == 1 else 5
        toks, nv = _stream(chunk)
        B = toks.shape[0]
        st = tm.make_states(B, toks.shape[1], torch.float32, chunk=chunk,
                            device='cpu')
        pos = np.zeros(B, np.int32)
        for jl, jpos in _jax_decode(both, chunk, table, fused, n_steps):
            tk = np.stack([toks[b, pos[b]:pos[b] + chunk] for b in range(B)])
            kw = dict(n_valid=torch.from_numpy(nv),
                      fused_gather_rope=fused) if chunk > 1 else {}
            tl, st = tm.decode_step(tp, torch.from_numpy(tk), st,
                                    torch.from_numpy(pos),
                                    precomputed=tt if table else None,
                                    attn_backend=backend, **kw)
            for b in range(B):
                n = int(nv[b]) if chunk > 1 else 1
                np.testing.assert_allclose(
                    tl[b, :n].numpy(), jl[b, :n], **TOL,
                    err_msg=f'chunk {chunk} table {table} fused {fused}')
            for got, want in zip(_pos_leaves(st), jpos):
                np.testing.assert_array_equal(got, want)
            pos = pos + (nv if chunk > 1 else 1)


# ------------------------------------------------------------- Model.apply
@pytest.mark.parametrize('S', [16, A.BLOCKED_THRESHOLD])
def test_apply_matches_jax(both, S):
    """Baseline and with the table against JAX's ``Model.apply`` (S 2048
    crosses into both frameworks' blocked cores; the port's flash wrapper
    runs its plain version here), and the two against each other inside
    the port (the paper's contract)."""
    jm, jp, jt, tm, tp, tt = both
    B = 2 if S == 16 else 1
    tok = np.random.default_rng(S).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    out = {}
    for pre in (False, True):
        want, jaux = jm.apply(jp, {'tokens': jnp.asarray(tok)},
                              precomputed=jt if pre else None)
        got, aux = tm.apply(tp, {'tokens': torch.from_numpy(tok)},
                            precomputed=tt if pre else None)
        assert got.shape == (B, S, tm.cfg.vocab_size)
        assert aux.dtype == torch.float32 and float(aux) == 0.0 == \
            float(jaux)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f'precomputed {pre}')
        out[pre] = got
    torch.testing.assert_close(out[True], out[False], **TOL)


# --------------------------------------------------------- paged engine
PS, MAX_SEQ = 8, 64


def _shared_prompts(seed=1):
    """A 24-token shared prefix (3 pages) and distinct tails; one prompt
    is a head of another's tail and one is the prefix itself: both stop
    inside a cached page (copy-on-write)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, 503, 24).astype(np.int32)
    tails = [rng.integers(3, 503, n).astype(np.int32) for n in (13, 5, 9)]
    prompts = [np.concatenate([prefix, t]) for t in tails]
    prompts += [np.concatenate([prefix, tails[0][:4]]), prefix.copy()]
    return prompts


def _serve(eng, req_cls, prompts, new_tokens=6):
    reqs = [req_cls(uid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
def test_paged_engine_matches_jax(both, backend):
    """The paged engine with the radix cache, the table and the fused
    gather-RoPE, chunk 4: greedy tokens and per-request prefix hits equal
    the JAX paged engine's, through copies on write."""
    jm, jp, jt, tm, tp, tt = both
    kw = dict(max_slots=2, max_seq=MAX_SEQ, chunk_size=4,
              fused_gather_rope=True, prefix_cache=True, page_size=PS)
    if 'engine' not in _MEMO:
        jeng = JaxEngine(jm, jp, precomputed=jt, attn_backend='reference',
                         **kw)
        jreqs = _serve(jeng, JaxRequest, _shared_prompts())
        _MEMO['engine'] = ([r.generated for r in jreqs],
                           [r.prefix_hit_tokens for r in jreqs])
    tokens, hits = _MEMO['engine']
    eng = ServingEngine(tm, tp, precomputed=tt, attn_backend=backend,
                        device='cpu', **kw)
    assert eng.fused_gather_rope
    reqs = _serve(eng, Request, _shared_prompts())
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert [r.generated for r in reqs] == tokens
    assert [r.prefix_hit_tokens for r in reqs] == hits
    assert eng.cow_copies >= 2 and 23 in hits
