"""gemma3 in the port (``repro_torch``) against the JAX package: ``qk_norm``
folded into the precomputed table, the ``sqrt(d)`` embedding scale, two RoPE
thetas (10k local, 1M global) over the 5:1 local/global pattern, through
the dense ring caches and the paged pool with ring pages and snapshots.

Configs: the smoke configs of gemma3-1b (KV 1, G 4) and gemma3-27b (KV 2,
G 2), each at 7 layers (``DEPTH``): at their own 2 layers both are
``'local'`` only, while 7 give layer 0 and one repetition of the pattern
with its ``'global'`` layer, so both thetas and both cache kinds run (the
full-width plans, with their tails, in
:func:`test_pattern_thetas_and_schema`). fp32, the same numpy weights in both packages
(``PRNGKey(0)``), every norm scale (``q_norm`` / ``k_norm`` included)
drawn as ``1 + 0.1 N(0, 1)``: scales of one would hide a missing multiply.

- The table (rows ``[x, q, k, v]``) against JAX's
  ``build_precomputed_table``; its ``x`` is the embedding times ``sqrt(d)``
  rounded in the working dtype (bf16 tables bitwise JAX's piece), its
  ``q`` / ``k`` carry the per-head RMSNorm.
- ``Model.apply``, baseline and with the table, and ``decode_step`` at chunk 1 and 4 (with the
  table, the fused gather-RoPE at chunk 4), both port backends.
- Engines' greedy tokens: paged with ring pages and linear pages against
  JAX's paged engine (snapshot hits; fp32 and int8); the port's dense ring
  caches and a small pool (preemptions) give the same tokens.
- Inside the port, bitwise: a chunked prefill equals token-by-token steps,
  and packed prefill equals unpacked (tokens and ``score()`` logits). With
  the real tied head, whose CPU matmul may block by row count, both give
  the same greedy tokens and logits within ``HEAD_TOL``.
- The plain versions at d 256 (gemma3-1b's head width): the split
  ``paged_attention``'s arithmetic (dense and int8) against JAX's
  ``paged_attention`` (interpret mode), ``flash_attention`` against JAX's
  flash kernel.

Tolerance: ``tests/test_precompute_equivalence.py``'s atol 2e-4 / rtol
2e-3 (the int8 engine's greedy tokens are held equal, exactly). The
``cuda`` twins of the d 256 kernels are in ``tests/test_torch_kernels.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.precompute import build_precomputed_table as jax_table
from repro.kernels import ops as JO
from repro.kernels import paged_attention as JPA
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.precompute import build_precomputed_table
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_attention_chunked_plain, quant_split_form, split_form)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.models.transformer import layer_plan
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = ['gemma3_1b', 'gemma3_27b']
DEPTH = 7
TOL = dict(atol=2e-4, rtol=2e-3)
# the real tied head, h @ embed.T, at two row layouts of one fp32 input:
# CPU BLAS may block the matmul by row count, so a logit (|logits| <= 1
# here) moves by a few ulps, never more
HEAD_TOL = dict(atol=1e-6, rtol=1e-6)
PS, MAX_SEQ, NEW = 8, 64, 6
SMALL_POOL = 12           # too small for two requests at once: preemptions
_MEMO = {}


def _cfg(get, arch):
    return dataclasses.replace(get(arch), num_layers=DEPTH)


def _perturb(tree):
    """Every ``scale`` leaf drawn as 1 + 0.1 N(0, 1), others kept."""
    rng = np.random.default_rng(11)

    def f(path, x):
        if getattr(path[-1], 'key', None) == 'scale':
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(f, tree)


def _models(arch):
    """(JAX model, JAX params, JAX table, port model, port params, port
    table) on one set of weights, made once per arch."""
    if arch not in _MEMO:
        jm = JaxModel(_cfg(jax_smoke_config, arch))
        npt = _perturb(jm.init(jax.random.PRNGKey(0)))
        jp = jax.tree.map(jnp.asarray, npt)
        tm = Model(_cfg(get_smoke_config, arch))
        tp = from_numpy_tree(npt, device='cpu')
        _MEMO[arch] = (jm, jp, jax_table(jp, jm.cfg), tm, tp,
                       tm.build_table(tp))
    return _MEMO[arch]


def _memo(key, make):
    if key not in _MEMO:
        _MEMO[key] = make()
    return _MEMO[key]


# ------------------------------------------------------- config and table
def test_pattern_thetas_and_schema():
    """Full-width plans (gemma3-1b: layer 0, 4 repetitions, a tail of 1;
    gemma3-27b: layer 0, 10, 1), each layer's theta, and the ``q_norm`` /
    ``k_norm`` leaves (ones at init, head_dim wide) in JAX's tree."""
    for arch, reps in (('gemma3_1b', 4), ('gemma3_27b', 10)):
        cfg = get_config(arch)
        plan = layer_plan(cfg)
        assert (plan.kinds[0], plan.reps, plan.n_tail) == ('local', reps, 1)
        assert plan.slots == ('local',) * 4 + ('global', 'local')
        assert [cfg.layer_rope_theta(k) for k in ('local', 'global')] == \
            [1e4, 1e6]
    jm, jp, _, tm, tp, _ = _models('gemma3_1b')
    ti = tm.init(seed=1, device='cpu')

    def structure(tree):
        return jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, tree))
    assert structure(ti) == structure(tp) == structure(jp)
    att = ti['backbone']['layer0']['attn']
    for nm in ('q_norm', 'k_norm'):
        assert att[nm]['scale'].shape == (tm.cfg.head_dim,)
        assert bool((att[nm]['scale'] == 1).all())


@pytest.mark.parametrize('arch', ARCHS)
def test_table_matches_jax(arch):
    """Rows against JAX's table; ``x`` is the scaled embedding and ``q`` /
    ``k`` the per-head normed projections of LN1(x) (the perturbed scales
    make both visible)."""
    _, _, jt, tm, tp, tt = _models(arch)
    cfg = tm.cfg
    assert tt.layout == jt.layout
    np.testing.assert_allclose(tt.table.numpy(), np.asarray(jt.table), **TOL)
    lay0 = tp['backbone']['layer0']
    x = tp['embed']['table'] * torch.tensor(cfg.d_model ** 0.5)
    pieces = tt.split(tt.table)
    assert torch.equal(pieces['x'], x)
    xn = L.rmsnorm(x, lay0['ln1']['scale'])
    raw = (xn @ lay0['attn']['wq']['w']).view(-1, cfg.num_heads,
                                             cfg.head_dim)
    want = L.rmsnorm(raw, lay0['attn']['q_norm']['scale']).flatten(1)
    torch.testing.assert_close(pieces['q'], want, **TOL)
    assert not torch.allclose(pieces['q'], L.rmsnorm(
        raw, torch.ones(cfg.head_dim)).flatten(1), **TOL)


def test_table_embed_scale_rounds_in_working_dtype():
    """In bf16 the embedding is cast first and multiplied by sqrt(d) as a
    bf16 (JAX's ``x * asarray(sqrt(d), bf16)``): the table's ``x`` piece is
    bitwise JAX's, and differs from the product rounded once from fp32."""
    jm, jp, _, tm, tp, _ = _models('gemma3_1b')
    cfg = dataclasses.replace(tm.cfg, dtype='bfloat16')
    jcfg = dataclasses.replace(jm.cfg, dtype='bfloat16')
    tpb = jax.tree.map(lambda t: t.bfloat16(), tp)
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tt = build_precomputed_table(tpb, cfg)
    got = tt.split(tt.table)['x']
    want = jax_table(jpb, jcfg).table[:, :cfg.d_model]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    once = (tpb['embed']['table'].float() * cfg.d_model ** 0.5).bfloat16()
    assert not torch.equal(got, once)


# --------------------------------------------------------- Model.apply
@pytest.mark.parametrize('arch', ARCHS)
def test_apply_matches_jax(arch):
    """Baseline and with the table against JAX's baseline ``Model.apply``
    at B 2, S 16 (the table against JAX's own in
    :func:`test_table_matches_jax`)."""
    jm, jp, jt, tm, tp, tt = _models(arch)
    B, S = 2, 16
    tok = np.random.default_rng(S).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jm.apply(jp, {'tokens': jnp.asarray(tok)})
    for pre in (False, True):
        got, _ = tm.apply(tp, {'tokens': torch.from_numpy(tok)},
                          precomputed=tt if pre else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f'precomputed {pre}')


# ------------------------------------------------------------- decode
def _stream(chunk):
    B, S = 3, 40
    toks = np.random.default_rng(7).integers(0, 503, (B, S)).astype(np.int32)
    nv = np.array([chunk, max(chunk - 1, 1), 0 if chunk > 1 else 1],
                  np.int32)
    return toks, nv


def _jax_decode(arch, chunk, n_steps):
    """JAX logits after each step (table; fused gather-RoPE at chunk > 1)."""
    def make():
        jm, jp, jt = _models(arch)[:3]
        toks, nv = _stream(chunk)
        B = toks.shape[0]
        st = jm.make_states(B, toks.shape[1], jnp.float32, chunk=chunk)
        pos = np.zeros(B, np.int32)
        kw = dict(n_valid=jnp.asarray(nv), fused_gather_rope=True) \
            if chunk > 1 else {}
        step = jax.jit(lambda p, tk, st, ps: jm.decode_step(
            p, tk, st, ps, precomputed=jt, attn_backend='reference', **kw))
        out = []
        for _ in range(n_steps):
            tk = np.stack([toks[b, pos[b]:pos[b] + chunk] for b in range(B)])
            lg, st = step(jp, jnp.asarray(tk), st, jnp.asarray(pos))
            out.append(np.asarray(lg))
            pos = pos + (nv if chunk > 1 else 1)
        return out
    return _memo(('decode', arch, chunk), make)


@pytest.mark.parametrize('chunk', [1, 4])
@pytest.mark.parametrize('arch', ARCHS)
def test_decode_matches_jax(arch, chunk):
    """Logits of the valid lanes after each step, over enough steps to wrap
    the local rings (window 8), both port backends."""
    _, _, _, tm, tp, tt = _models(arch)
    n_steps = 10 if chunk == 1 else 5
    toks, nv = _stream(chunk)
    B = toks.shape[0]
    for backend in ('reference', 'cuda'):
        st = tm.make_states(B, toks.shape[1], torch.float32, chunk=chunk,
                            device='cpu')
        pos = np.zeros(B, np.int32)
        for jl in _jax_decode(arch, chunk, n_steps):
            tk = np.stack([toks[b, pos[b]:pos[b] + chunk] for b in range(B)])
            kw = dict(n_valid=torch.from_numpy(nv), fused_gather_rope=True) \
                if chunk > 1 else {}
            tl, st = tm.decode_step(tp, torch.from_numpy(tk), st,
                                    torch.from_numpy(pos), precomputed=tt,
                                    attn_backend=backend, **kw)
            for b in range(B):
                n = int(nv[b]) if chunk > 1 else 1
                np.testing.assert_allclose(tl[b, :n].numpy(), jl[b, :n],
                                           **TOL, err_msg=backend)
            pos = pos + (nv if chunk > 1 else 1)


@pytest.mark.parametrize('kv_quant', [False, True])
def test_chunked_equals_token_by_token_bitwise(kv_quant):
    """Inside the port (gemma3-1b, reference backend, the same ring
    geometry): a chunked prefill writes the same caches and gives the same
    final hidden states as token-by-token steps, bit for bit. (The tied
    head, ``h @ embed.T``, is one matmul of those states; CPU BLAS may
    block it differently at B*T rows than at B rows:
    :func:`test_chunked_tied_head_matches_token_by_token`.)"""
    _, _, _, tm, tp, _ = _models('gemma3_1b')
    B, S, T = 2, 24, 4
    toks = np.random.default_rng(8).integers(0, 503, (B, S)).astype(np.int32)

    def states():
        return tm.make_states(B, S, torch.float32, chunk=T, device='cpu',
                              kv_quant=kv_quant)
    one, lg_one = states(), []
    for p in range(S):
        lg, one = tm.decode_step(tp, torch.from_numpy(toks[:, p:p + 1]), one,
                                 torch.full((B,), p, dtype=torch.int32),
                                 attn_backend='reference', return_hidden=True)
        lg_one.append(lg)
    ch, lg_ch = states(), []
    for p in range(0, S, T):
        lg, ch = tm.decode_step(
            tp, torch.from_numpy(toks[:, p:p + T]), ch,
            torch.full((B,), p, dtype=torch.int32),
            n_valid=torch.full((B,), T, dtype=torch.int32),
            attn_backend='reference', return_hidden=True)
        lg_ch.append(lg)
    assert torch.equal(torch.cat(lg_ch, dim=1), torch.cat(lg_one, dim=1))
    for a, b in zip(jax.tree_util.tree_leaves(ch),
                    jax.tree_util.tree_leaves(one)):
        assert torch.equal(a, b)


def test_chunked_tied_head_matches_token_by_token():
    """The same runs with gemma3-1b's real tied head (no
    ``return_hidden``): the chunked prefill's logits are the token-by-token
    steps' within HEAD_TOL, and their greedy tokens equal."""
    _, _, _, tm, tp, _ = _models('gemma3_1b')
    B, S, T = 2, 24, 4
    toks = np.random.default_rng(8).integers(0, 503, (B, S)).astype(np.int32)
    logits = {}
    for chunk in (1, T):
        st, out = tm.make_states(B, S, torch.float32, chunk=T,
                                 device='cpu'), []
        for p in range(0, S, chunk):
            kw = {} if chunk == 1 else dict(
                n_valid=torch.full((B,), T, dtype=torch.int32))
            lg, st = tm.decode_step(
                tp, torch.from_numpy(toks[:, p:p + chunk]), st,
                torch.full((B,), p, dtype=torch.int32),
                attn_backend='reference', **kw)
            out.append(lg)
        logits[chunk] = torch.cat(out, dim=1)
    assert logits[T].shape == (B, S, tm.cfg.vocab_size)
    assert torch.equal(logits[T].argmax(-1), logits[1].argmax(-1))
    torch.testing.assert_close(logits[T], logits[1], **HEAD_TOL)


# ------------------------------------------------------------- engines
def _waves(vocab):
    """Wave 1: prompts of 30, 37 and 26 tokens (snapshots at 24, 32, 24).
    Wave 2: the first prompt's second turn (prompt + its tokens + 5 new:
    a hit at 24) and the second prompt again (a hit at 32)."""
    rng = np.random.default_rng(3)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in (30, 37, 26)]


def _serve(eng, req_cls):
    first = [req_cls(uid=i, prompt=p, max_new_tokens=NEW)
             for i, p in enumerate(_waves(eng.model.cfg.vocab_size))]
    for r in first:
        eng.submit(r)
    eng.run()
    a, b = first[0], first[1]
    tail = np.random.default_rng(4).integers(3, 503, 5).astype(np.int32)
    second = [req_cls(uid=10 + i, prompt=p, max_new_tokens=NEW)
              for i, p in enumerate([np.concatenate(
                  [a.prompt, np.asarray(a.generated, np.int32), tail]),
                  b.prompt.copy()])]
    for r in second:
        eng.submit(r)
    eng.run()
    reqs = first + second
    assert all(r.status.name == 'FINISHED' for r in reqs), \
        [(r.uid, r.status, r.error) for r in reqs]
    return ([list(r.generated) for r in reqs],
            [r.prefix_hit_tokens for r in reqs])


def _engine_kw(paged, kv_quant, num_pages=None):
    kw = dict(max_slots=2, max_seq=MAX_SEQ, chunk_size=4,
              fused_gather_rope=True, kv_quant=kv_quant)
    if paged:
        kw.update(prefix_cache=True, page_size=PS, num_pages=num_pages)
    return kw


def _jax_engine(arch, paged, kv_quant, num_pages=None):
    def make():
        jm, jp, jt = _models(arch)[:3]
        eng = JaxEngine(jm, jp, precomputed=jt, attn_backend='reference',
                        **_engine_kw(paged, kv_quant, num_pages))
        out = _serve(eng, JaxRequest)
        return out + (eng.preemptions,)
    return _memo(('engine', arch, paged, kv_quant, num_pages), make)


@pytest.mark.parametrize('arch,kv_quant', [('gemma3_27b', False),
                                           ('gemma3_1b', True)])
def test_engine_matches_jax(arch, kv_quant):
    """Greedy tokens and per-request prefix hits of the port's paged engine
    (ring pages and linear pages; both backends, the ``cuda`` one running
    the kernels' plain versions and the fused, deferred-clear write path)
    equal JAX's paged engine's: snapshot hits at 24 and 32, no
    copy-on-write; fp32 and int8 pages. In fp32 the same tokens from the
    port's dense engine (ring caches) and from its paged engine in a pool
    too small for two requests (preemptions)."""
    _, _, _, tm, tp, tt = _models(arch)
    tokens, hits, preempt = _jax_engine(arch, True, kv_quant)
    assert hits == [0, 0, 0, 24, 32] and preempt == 0
    for backend in ('reference', 'cuda'):
        eng = ServingEngine(tm, tp, precomputed=tt, attn_backend=backend,
                            device='cpu', **_engine_kw(True, kv_quant))
        assert eng._needs_snapshot and eng._lin_layers
        assert _serve(eng, Request) == (tokens, hits), backend
        assert eng.cow_copies == 0
    if kv_quant:
        return
    small = ServingEngine(tm, tp, precomputed=tt, attn_backend='cuda',
                          device='cpu', **_engine_kw(True, False, SMALL_POOL))
    assert _serve(small, Request)[0] == tokens and small.preemptions > 0
    dense = ServingEngine(tm, tp, precomputed=tt, attn_backend='cuda',
                          device='cpu', **_engine_kw(False, False))
    assert _serve(dense, Request)[0] == tokens


def _rowwise_head(params, h_normed, cfg):
    """The tied head one row at a time: CPU BLAS blocks ``h @ embed.T``
    by the number of rows, so a row's logits would depend on how many rows
    share the call (the packed grid has other row counts)."""
    rows = h_normed.reshape(-1, h_normed.shape[-1])
    w = params['embed']['table']
    out = torch.stack([r[None] @ w.T for r in rows])
    return out.reshape(tuple(h_normed.shape[:-1]) + (-1,))


@pytest.mark.parametrize('paged', [False, True])
def test_packed_bitwise_unpacked(paged, monkeypatch):
    """gemma3-27b: greedy tokens and ``score()`` logits of the packed
    engine are bitwise the unpacked one's (cuda backend's plain versions;
    the tied head computed row by row, ``_rowwise_head``; the real one in
    :func:`test_packed_tied_head_matches_unpacked`)."""
    monkeypatch.setattr(T, 'lm_head', _rowwise_head)
    _, _, _, tm, tp, tt = _models('gemma3_27b')
    out = {}
    for pack in (False, True):
        eng = ServingEngine(tm, tp, precomputed=tt, attn_backend='cuda',
                            device='cpu', pack_prefill=pack,
                            **dict(_engine_kw(paged, False), max_slots=4))
        tokens, _ = _serve(eng, Request)
        scores = eng.score([_waves(503)[1], _waves(503)[2]])
        out[pack] = (tokens, [s.tobytes() for s in scores])
        assert eng.pack_prefill == pack
    assert out[True] == out[False]


def test_packed_tied_head_matches_unpacked():
    """gemma3-27b's paged engine (ring pages and linear pages) with its
    real tied head: the packed engine's greedy tokens equal the unpacked
    one's and its ``score()`` logits agree within HEAD_TOL."""
    _, _, _, tm, tp, tt = _models('gemma3_27b')
    out = {}
    for pack in (False, True):
        eng = ServingEngine(tm, tp, precomputed=tt, attn_backend='cuda',
                            device='cpu', pack_prefill=pack,
                            **dict(_engine_kw(True, False), max_slots=4))
        out[pack] = (_serve(eng, Request),
                     eng.score([_waves(503)[1], _waves(503)[2]]))
    assert out[True][0] == out[False][0]
    for got, want in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(got, want, **HEAD_TOL)


# ------------------------------------------------- plain versions at d 256
def _d256_case(seed, quant):
    """gemma3-1b's attend (KV 1, G 4, d 256), T 16: three slots through a
    scattered table of 16-token pages (one slot empty)."""
    rng = np.random.default_rng(seed)
    B, T, KV, G, d, ps, P = 3, 16, 1, 4, 256, 16, 12
    NP = 1 + B * P
    table = (rng.permutation(NP - 1) + 1).reshape(B, P).astype(np.int32)
    cpos = np.full((NP, ps), -1, np.int32)
    for b, n in enumerate((150, 97, 0)):
        for p in range(n):
            cpos[table[b, p // ps], p % ps] = p
    pos0 = np.array([134, 81, 0], np.int32)
    q = rng.standard_normal((B, T, KV, G, d)).astype(np.float32)
    if quant:
        k, v = (rng.integers(-127, 128, (NP, ps, KV, d)).astype(np.int8)
                for _ in range(2))
        ks, vs = (torch.from_numpy(rng.random((NP, ps, KV)) * 0.05 + 1e-3)
                  .bfloat16() for _ in range(2))
        return q, k, v, cpos, table, pos0, ks, vs
    k, v = (rng.standard_normal((NP, ps, KV, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, cpos, table, pos0, None, None


@pytest.mark.parametrize('quant', [False, True])
@pytest.mark.parametrize('window', [0, 40])
def test_split_plain_d256_matches_jax(quant, window):
    """The split kernels' arithmetic (chunks of 64 keys) at d 256 against
    JAX's ``paged_attention`` in interpret mode (with the scales for
    int8), within KERNEL_TOL; an empty slot gives zeros. bf16 q over bf16
    (or int8) pages at d 256 takes the split form on the card."""
    q, k, v, cpos, table, pos0, ks, vs = _d256_case(5 + window, quant)
    kw = dict(scale=256 ** -0.5, window=window)
    sc = {} if ks is None else dict(k_scale_pages=ks, v_scale_pages=vs)
    got = paged_attention_chunked_plain(
        *map(torch.from_numpy, (q, k, v, cpos, table, pos0)), chunk=64,
        **sc, **kw)
    jsc = {} if ks is None else {
        n: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        for n, t in sc.items()}
    want = np.asarray(JPA.paged_attention(
        *map(jnp.asarray, (q, k, v, cpos, table, pos0)), **jsc, **kw,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    assert not got[2].any()
    qb = torch.zeros((1, 1, 1, 4, 256), dtype=torch.bfloat16)
    pages = torch.zeros((1, 1, 1, 256), dtype=torch.int8 if quant
                        else torch.bfloat16)
    assert (quant_split_form(qb, pages) if quant
            else split_form(qb, pages, pages))


@pytest.mark.parametrize('window', [0, 64])
def test_flash_plain_d256_matches_jax(window):
    """``flash_attention`` (its plain version on the CPU) at gemma3-1b's
    heads, H 4 over KV 1, d 256, S 200 (not a multiple of the block),
    against JAX's flash kernel in interpret mode (block 64)."""
    rng = np.random.default_rng(window)
    S = 200
    q = rng.standard_normal((1, S, 4, 256)).astype(np.float32)
    k, v = (rng.standard_normal((1, S, 1, 256)).astype(np.float32)
            for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32)[None]
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), pos,
                          window=window)
    want = JO.flash_attention_bshd(*map(jnp.asarray, (q, k, v)),
                                   window=window, block=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
