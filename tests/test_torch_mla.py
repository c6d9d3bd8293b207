"""The port's MLA attention and the deepseek-v2-lite-16b slice against the
JAX package, on the deepseek smoke config in fp32 with the same (bridged)
weights and numpy inputs made with a seed. Tolerance: atol 2e-4, rtol 2e-3
(``tests/test_precompute_equivalence.py``) for activations and logits;
cache positions exactly; greedy tokens equal.

- Modules: ``compute_latents``, ``mla_decode_chunk`` on dense and paged
  latent caches (both backends; on the CPU the ``cuda`` backend's kernel
  wrappers run their plain versions), the latent ring write bitwise.
- Kernels' plain versions: ``paged_attention_plain``'s MLA form against
  the JAX kernel in interpret mode (fp32 queries over fp32 and bf16
  pages), ``gather_rope_plain`` over the MLA segments (one per head's
  q_pe slice plus k_pe) against ``ops.gather_rope_rows_segs``.
- The slice: the precomputed table, model decode steps (one-token and
  chunked, with the fused gather→RoPE), and the engine's greedy tokens
  against the JAX engine, dense and paged with prefix hits.
- Inside the port, bitwise: chunked equals token-by-token on MLA + MoE,
  and the paged engine equals the dense one.

The ``cuda``-marked tests of the MLA kernel and the 17-segment
``gather_rope`` against their plain versions are in
``tests/test_torch_kernels.py``, which runs on a card without JAX.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as JOPS
from repro.kernels import paged_attention as JPA
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mla as JM
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.gather_rope import gather_rope_plain
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_plain)
from repro_torch.models import attention as A
from repro_torch.models import mla as M
from repro_torch.models.attn_backend import KERNEL_TOL
from repro_torch.models.model import Model
from repro_torch.models.transformer import (_fused_gather_rope_pre0,
                                            fused_rope_eligible)
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, RequestStatus, ServingEngine

ARCH = 'deepseek_v2_lite_16b'
TOL = dict(atol=2e-4, rtol=2e-3)
PS, MAX_SEQ = 8, 64


@pytest.fixture(scope='module')
def both():
    jm = JaxModel(jax_smoke_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config(ARCH))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
    return jm, jp, tm, tp


@pytest.fixture(scope='module')
def attn(both):
    """Layer 0's MLA parameters in both packages."""
    _, jp, _, tp = both
    return jp['backbone']['layer0']['attn'], tp['backbone']['layer0']['attn']


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ----------------------------------------------------------------- modules
def test_config_and_schema_shapes(both):
    cfg = get_config(ARCH)
    assert cfg.precompute_row_width == 2048 + 16 * 192 + 512 + 64 == 5696
    jm, jp, tm, _ = both
    ti = tm.init(seed=1, device='cpu')
    assert jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, jp)) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, ti))
    assert [a.shape for a in jax.tree_util.tree_leaves(jp)] == \
        [tuple(t.shape) for t in jax.tree_util.tree_leaves(ti)]
    # the router keeps fp32 in a bf16 model; the rest follows the model
    tb = tm.init(seed=1, device='cpu', dtype=torch.bfloat16)
    body = tb['backbone']['body'][0]
    assert body['moe']['router'].dtype == torch.float32
    assert body['moe']['w_up'].dtype == torch.bfloat16
    assert tb['backbone']['layer0']['ffn']['w_up']['w'].shape == (128, 256)


def test_compute_latents_match_jax(both, attn):
    ja, ta = attn
    cfg = get_smoke_config(ARCH)
    x = np.random.default_rng(0).standard_normal((3, 5, cfg.d_model)) \
        .astype(np.float32)
    want = JM.compute_latents(ja, jnp.asarray(x), jax_smoke_config(ARCH))
    got = M.compute_latents(ta, torch.from_numpy(x), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize('Sc,T,n_valid', [(11, 4, [4, 3, 0]),
                                          (5, 8, [8, 7, 2])])
def test_latent_ring_write_matches_jax_bitwise(Sc, T, n_valid):
    rng = np.random.default_rng(Sc)
    B, r, dr = 3, 6, 4
    cache = {'ckv': rng.standard_normal((B, Sc, r)).astype(np.float32),
             'kpe': rng.standard_normal((B, Sc, dr)).astype(np.float32),
             'pos': rng.integers(-1, 9, (B, Sc)).astype(np.int32)}
    ckv = rng.standard_normal((B, T, r)).astype(np.float32)
    kpe = rng.standard_normal((B, T, dr)).astype(np.float32)
    pos0 = np.array([9, 2, 17], np.int32)
    nv = np.array(n_valid, np.int32)
    want = JM.mla_cache_update_chunk(
        {n: jnp.asarray(a) for n, a in cache.items()}, jnp.asarray(ckv),
        jnp.asarray(kpe), jnp.asarray(pos0), jnp.asarray(nv))
    got = M.mla_cache_update_chunk(
        {n: torch.from_numpy(a.copy()) for n, a in cache.items()},
        torch.from_numpy(ckv), torch.from_numpy(kpe), torch.from_numpy(pos0),
        torch.from_numpy(nv))
    for n in cache:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def _chunk_steps():
    """Three chunk steps of 3 slots: a cold slot, a slot mid-prompt and a
    slot that sits out the middle step (n_valid 0)."""
    return [(np.array([0, 0, 0]), np.array([4, 3, 4])),
            (np.array([4, 3, 4]), np.array([4, 2, 0])),
            (np.array([8, 5, 4]), np.array([1, 4, 3]))]


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
@pytest.mark.parametrize('paged', [False, True])
def test_mla_decode_chunk_matches_jax(attn, paged, backend):
    ja, ta = attn
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    B, T = 3, 4
    rng = np.random.default_rng(3)
    P = MAX_SEQ // PS
    NP = 1 + B * P
    if paged:
        pt = np.zeros((B, P), np.int32)
        pages = rng.permutation(NP - 1)[:B * 2] + 1   # 2 pages a slot
        pt[:, :2] = pages.reshape(B, 2)
        jc = JM.mla_make_paged_cache(jcfg, NP, PS, jnp.float32)
        tc = M.mla_make_paged_cache(cfg, NP, PS, torch.float32, 'cpu')
        jpg = JA.PageTables(jnp.asarray(pt), jnp.asarray(pt[:, :0]), 0)
    else:
        jc = JM.mla_make_cache(jcfg, B, MAX_SEQ, jnp.float32)
        tc = M.mla_make_cache(cfg, B, MAX_SEQ, torch.float32, 'cpu')
        jpg = None
    for pos0, nv in _chunk_steps():
        x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
        jo, jc = JM.mla_decode_chunk(ja, jnp.asarray(x), jc,
                                     jnp.asarray(pos0, jnp.int32),
                                     jnp.asarray(nv, jnp.int32), jcfg,
                                     rope_theta=jcfg.rope_theta, paged=jpg)
        p0, n = (torch.from_numpy(a.astype(np.int32)) for a in (pos0, nv))
        tpg = None
        if paged:
            tpg = A.PageTables(torch.from_numpy(pt),
                               torch.from_numpy(pt[:, :0]), 0)
            if backend == 'cuda':
                tpg = tpg.with_jobs(p0, n, PS, T)
        to, tc = M.mla_decode_chunk(ta, torch.from_numpy(x), tc, p0, n, cfg,
                                    rope_theta=cfg.rope_theta, paged=tpg,
                                    backend=backend)
        for b in range(B):
            np.testing.assert_allclose(to[b, :nv[b]].numpy(),
                                       np.asarray(jo)[b, :nv[b]], **TOL)
        np.testing.assert_array_equal(tc['pos'].numpy(),
                                      np.asarray(jc['pos']))
        for nm in ('ckv', 'kpe'):
            np.testing.assert_allclose(tc[nm].numpy(), np.asarray(jc[nm]),
                                       **TOL)


# ------------------------------------------------------------------ kernels
def _mla_pages(seed, B, T, H, r, dr, ps, lengths, page_dtype):
    """Latent pool pages with scattered per-slot tables; slot b holds
    positions [0, lengths[b]); unallocated blocks map to the null page."""
    rng = np.random.default_rng(seed)
    P = -(-max(max(lengths), 1) // ps) + 1
    NP = 1 + B * P
    perm = rng.permutation(NP - 1) + 1
    table = perm[:B * P].reshape(B, P).astype(np.int32)
    cpos = np.full((NP, ps), -1, np.int32)
    for b, n in enumerate(lengths):
        table[b, -(-n // ps):] = 0
        for p in range(n):
            cpos[table[b, p // ps], p % ps] = p
    ckv = rng.standard_normal((NP, ps, 1, r)).astype(np.float32)
    kpe = rng.standard_normal((NP, ps, 1, dr)).astype(np.float32)
    ckv[0] = kpe[0] = 0.0
    if page_dtype == 'bfloat16':      # values exactly representable in bf16
        ckv = np.array(jnp.asarray(ckv).astype(jnp.bfloat16)
                       .astype(jnp.float32))
        kpe = np.array(jnp.asarray(kpe).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    q = rng.standard_normal((B, T, 1, H, r + dr)).astype(np.float32)
    pos0 = np.array([max(n - T, 0) for n in lengths], np.int32)
    return q, ckv, kpe, cpos, table, pos0


@pytest.mark.parametrize('page_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('T', [1, 5])
def test_paged_attention_mla_plain_matches_jax(page_dtype, T):
    """fp32 queries over fp32 or bf16 latent pages through a scattered
    table: two slots mid-page and an empty slot (zeros)."""
    B, H, r, dr, ps = 3, 4, 32, 8, 8
    q, ckv, kpe, cpos, table, pos0 = _mla_pages(0, B, T, H, r, dr, ps,
                                                [29, 13, 0], page_dtype)
    kw = dict(scale=(16 + dr) ** -0.5, window=0)
    jdt = getattr(jnp, page_dtype)
    want = np.asarray(JPA.paged_attention(
        jnp.asarray(q), jnp.asarray(ckv).astype(jdt), None,
        jnp.asarray(cpos), jnp.asarray(table), jnp.asarray(pos0),
        k2_pages=jnp.asarray(kpe).astype(jdt), mla_split=r,
        interpret=True, **kw))
    tdt = getattr(torch, page_dtype)
    args = (torch.from_numpy(q), torch.from_numpy(ckv).to(tdt), None,
            torch.from_numpy(cpos), torch.from_numpy(table),
            torch.from_numpy(pos0))
    got = paged_attention(*args, k2_pages=torch.from_numpy(kpe).to(tdt),
                          mla_split=r, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, T, 1, H, r)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    assert not got[2].any()
    plain = paged_attention_plain(*args, k2_pages=torch.from_numpy(kpe).to(
        tdt), mla_split=r, **kw)
    assert torch.equal(got, plain)


@pytest.mark.parametrize('full', [False, True])
def test_gather_rope_mla_segments_match_jax(both, full):
    """The fused gather's MLA segments (one per head's q_pe slice plus
    k_pe): the smoke config's 5, and full width's 17 over 5696-wide rows
    of a small vocabulary."""
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    m = cfg.mla
    V, W, N = 40, cfg.precompute_row_width, 6
    rng = np.random.default_rng(5)
    tab = rng.standard_normal((V, W)).astype(np.float32)
    ids = rng.integers(0, V, N).astype(np.int32)
    pos = rng.integers(0, 4096, N).astype(np.int32)
    d, dn, dr = cfg.d_model, m.qk_nope_dim, m.qk_rope_dim
    segs = tuple((d + h * (dn + dr) + dn, 1, dr)
                 for h in range(cfg.num_heads))
    segs += ((d + cfg.q_size + m.kv_lora_rank, 1, dr),)
    assert len(segs) == cfg.num_heads + 1
    want = np.asarray(JOPS.gather_rope_rows_segs(
        jnp.asarray(tab), jnp.asarray(ids), jnp.asarray(pos), segs=segs,
        theta=cfg.rope_theta))
    got = gather_rope_plain(torch.from_numpy(tab), torch.from_numpy(ids),
                            torch.from_numpy(pos), segs=segs,
                            theta=cfg.rope_theta).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    rotated = np.zeros(W, bool)
    for off, _, w in segs:
        rotated[off:off + w] = True
    np.testing.assert_array_equal(got[:, ~rotated], tab[ids][:, ~rotated])


# -------------------------------------------------------------------- slice
def test_table_matches_jax(both):
    jm, jp, tm, tp = both
    jt, tt = jm.build_table(jp), tm.build_table(tp)
    assert tt.layout == jt.layout == (('x', 128), ('q', 96), ('ckv', 32),
                                      ('kpe', 8))
    np.testing.assert_allclose(tt.table.numpy(), np.asarray(jt.table),
                               atol=1e-5, rtol=1e-5)
    assert fused_rope_eligible(tt, tm.cfg)


def test_fused_gather_rope_rows_match_jax(both):
    from repro.models import transformer as JT
    jm, jp, tm, tp = both
    jt, tt = jm.build_table(jp), tm.build_table(tp)
    rng = np.random.default_rng(6)
    tok = rng.integers(0, 503, (3, 4)).astype(np.int32)
    pos_t = rng.integers(0, 300, (3, 4)).astype(np.int32)
    want = JT._fused_gather_rope_pre0(jt, jnp.asarray(tok),
                                      jnp.asarray(pos_t), jm.cfg)
    got = _fused_gather_rope_pre0(tt, torch.from_numpy(tok),
                                  torch.from_numpy(pos_t), tm.cfg)
    for nm in ('x', 'q', 'ckv', 'kpe'):
        np.testing.assert_allclose(got[nm].numpy(), np.asarray(want[nm]),
                                   atol=1e-5, rtol=1e-5)


def _stream(chunk):
    B, S = 3, 40
    toks = np.random.default_rng(7).integers(0, 503, (B, S)).astype(np.int32)
    nv = np.array([chunk, max(chunk - 1, 1), 0 if chunk > 1 else 1],
                  np.int32)
    return toks, nv


@pytest.fixture(scope='module')
def jax_decode(both):
    """JAX logits, drops and cache positions per (chunk, table, fused)."""
    jm, jp, _, _ = both
    jt = jm.build_table(jp)
    memo = {}

    def get(chunk, table, fused, n_steps):
        key = (chunk, table, fused, n_steps)
        if key not in memo:
            toks, nv = _stream(chunk)
            B = toks.shape[0]
            st = jm.make_states(B, toks.shape[1], jnp.float32, chunk=chunk)
            pos = np.zeros(B, np.int32)
            kw = dict(n_valid=jnp.asarray(nv), fused_gather_rope=fused) \
                if chunk > 1 else dict(lane_valid=jnp.asarray(
                    np.array([True, True, False])))
            step = jax.jit(lambda p, tk, st, ps: jm.decode_step(
                p, tk, st, ps, precomputed=jt if table else None,
                attn_backend='reference', return_stats=True, **kw))
            out = []
            for _ in range(n_steps):
                tk = np.stack([toks[b, pos[b]:pos[b] + chunk]
                               for b in range(B)])
                lg, st, stats = step(jp, jnp.asarray(tk), st,
                                     jnp.asarray(pos))
                out.append((np.asarray(lg), int(stats['moe_drops']),
                            [np.asarray(st['layer0']['pos']),
                             np.asarray(st['body'][0]['pos'])]))
                pos = pos + (nv if chunk > 1 else 1)
            memo[key] = out
        return memo[key]
    return get


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
@pytest.mark.parametrize('chunk,table,fused', [(1, False, False),
                                               (1, True, False),
                                               (4, False, False),
                                               (4, True, True)])
def test_decode_matches_jax(both, jax_decode, chunk, table, fused, backend):
    """Model decode steps (MLA attention, dense then MoE FFN) on dense
    latent caches: logits of the valid lanes, drop counts and every cache
    position leaf after each step; the one-token steps mask slot 2 out of
    MoE routing."""
    _, _, tm, tp = both
    tt = tm.build_table(tp)
    n_steps = 8 if chunk == 1 else 5
    toks, nv = _stream(chunk)
    B = toks.shape[0]
    st = tm.make_states(B, toks.shape[1], torch.float32, chunk=chunk,
                        device='cpu')
    pos = np.zeros(B, np.int32)
    for jl, jd, jpos in jax_decode(chunk, table, fused, n_steps):
        tk = np.stack([toks[b, pos[b]:pos[b] + chunk] for b in range(B)])
        kw = dict(n_valid=torch.from_numpy(nv), fused_gather_rope=fused) \
            if chunk > 1 else dict(lane_valid=torch.tensor([True, True,
                                                            False]))
        tl, st, stats = tm.decode_step(
            tp, torch.from_numpy(tk), st, torch.from_numpy(pos),
            precomputed=tt if table else None, attn_backend=backend,
            return_stats=True, **kw)
        for b in range(B):
            n = int(nv[b]) if chunk > 1 else 1
            np.testing.assert_allclose(tl[b, :n].numpy(), jl[b, :n], **TOL)
        assert int(stats['moe_drops']) == jd
        got = [st['layer0']['pos'].numpy(), st['body'][0]['pos'].numpy()]
        for g, w in zip(got, jpos):
            np.testing.assert_array_equal(g, w)
        pos = pos + (nv if chunk > 1 else 1)


def test_chunked_equals_token_by_token_bitwise(both):
    """Inside the port, on MLA + MoE: a chunked prefill writes the same
    latent caches and gives the same logits as token-by-token steps, bit
    for bit (reference backend, table with the plain gather)."""
    _, _, tm, tp = both
    tt = tm.build_table(tp)
    B, S, T = 2, 12, 4
    toks = np.random.default_rng(8).integers(0, 503, (B, S)).astype(np.int32)
    one = tm.make_states(B, S, torch.float32, device='cpu')
    lg_one = []
    for p in range(S):
        lg, one = tm.decode_step(tp, torch.from_numpy(toks[:, p:p + 1]), one,
                                 torch.full((B,), p, dtype=torch.int32),
                                 precomputed=tt, attn_backend='reference')
        lg_one.append(lg)
    lg_one = torch.cat(lg_one, dim=1)
    ch = tm.make_states(B, S, torch.float32, chunk=T, device='cpu')
    lg_ch = []
    for p in range(0, S, T):
        lg, ch = tm.decode_step(tp, torch.from_numpy(toks[:, p:p + T]), ch,
                                torch.full((B,), p, dtype=torch.int32),
                                n_valid=torch.full((B,), T,
                                                   dtype=torch.int32),
                                precomputed=tt, attn_backend='reference')
        lg_ch.append(lg)
    assert torch.equal(torch.cat(lg_ch, dim=1), lg_one)
    leaves = lambda s: [s['layer0'][n] for n in ('ckv', 'kpe', 'pos')] + \
        [s['body'][0][n] for n in ('ckv', 'kpe', 'pos')]  # noqa: E731
    assert all(map(torch.equal, leaves(ch), leaves(one)))


def _shared_prompts(seed=1):
    """A 24-token shared prefix (3 pages) with distinct tails; one prompt
    stops short inside a cached page (copy-on-write)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, 503, 24).astype(np.int32)
    tails = [rng.integers(3, 503, n).astype(np.int32) for n in (13, 5, 9)]
    prompts = [np.concatenate([prefix, t]) for t in tails]
    prompts += [np.concatenate([prefix, tails[0][:4]]),
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
def jax_engine_runs(both):
    jm, jp, _, _ = both
    jt = jm.build_table(jp)
    memo = {}

    def get(chunk, paged):
        key = (chunk, paged)
        if key not in memo:
            kw = dict(prefix_cache=True, page_size=PS) if paged else {}
            eng = JaxEngine(jm, jp, max_slots=2, max_seq=MAX_SEQ,
                            chunk_size=chunk, precomputed=jt,
                            fused_gather_rope=chunk > 1,
                            attn_backend='reference', **kw)
            reqs = _serve(eng, JaxRequest, _shared_prompts())
            memo[key] = ([r.generated for r in reqs],
                         [r.prefix_hit_tokens for r in reqs],
                         eng.stats(reqs))
        return memo[key]
    return get


@pytest.mark.parametrize('backend', ['reference', 'cuda'])
@pytest.mark.parametrize('chunk,paged', [(1, False), (4, False), (4, True)])
def test_engine_matches_jax(both, jax_engine_runs, chunk, paged, backend):
    """Greedy tokens equal the JAX engine's (reference backend), dense and
    paged; paged, the per-request prefix hits (a copy-on-write included)
    and the pool's counters equal too."""
    _, _, tm, tp = both
    tokens, hits, jstats = jax_engine_runs(chunk, paged)
    kw = dict(prefix_cache=True, page_size=PS) if paged else {}
    eng = ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ,
                        chunk_size=chunk, precomputed=tm.build_table(tp),
                        fused_gather_rope=chunk > 1, attn_backend=backend,
                        device='cpu', **kw)
    reqs = _serve(eng, Request, _shared_prompts())
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert [r.generated for r in reqs] == tokens
    stats = eng.stats(reqs)
    assert stats['moe_token_drops'] == jstats['moe_token_drops']
    if paged:
        assert [r.prefix_hit_tokens for r in reqs] == hits
        for key in ('prefix_hits', 'prefix_misses', 'prefix_hit_tokens',
                    'pages_in_use'):
            assert stats[key] == jstats[key], key
        assert stats['prefix_hits'] >= 3 and stats['cow_copies'] >= 1


@pytest.mark.parametrize('chunk', [1, 4])
def test_paged_equals_dense_exactly(both, chunk):
    """Same weights and requests, the table with fused gather→RoPE: the
    paged engine's greedy tokens and prompt logits are the dense
    engine's, bit for bit, cold and on prefix hits."""
    _, _, tm, tp = both
    table = tm.build_table(tp)
    out = {}
    for paged in (False, True):
        kw = dict(prefix_cache=True, page_size=PS) if paged else {}
        eng = ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ,
                            chunk_size=chunk, precomputed=table,
                            fused_gather_rope=True, device='cpu', **kw)
        reqs = _serve(eng, Request, _shared_prompts(2), 8)
        out[paged] = ([r.generated for r in reqs],
                      [r.prefix_hit_tokens for r in reqs])
    assert out[True][0] == out[False][0]
    assert sum(out[True][1]) > 0


def test_pool_contents_equal_between_backends(both):
    """The fused write path (fused_page_write with deferred clears and
    cow_page_copy; plain versions here) leaves the ckv / kpe / pos pools
    bit for bit as the reference path's plain scatters with eager
    clears."""
    _, _, tm, tp = both
    engs = [ServingEngine(tm, tp, max_slots=2, max_seq=MAX_SEQ,
                          chunk_size=4, prefix_cache=True, page_size=PS,
                          num_pages=12, attn_backend=b, device='cpu')
            for b in ('reference', 'cuda')]
    for eng in engs:
        _serve(eng, Request, _shared_prompts(3))
        assert eng._pending_clear == []
    assert engs[1].cow_copies > 0
    for (ca, _), (cb, _) in zip(engs[0]._pools, engs[1]._pools):
        assert sorted(ca) == ['ckv', 'kpe', 'pos']
        for nm in ca:
            assert torch.equal(ca[nm], cb[nm]), nm


def test_serve_cli_deepseek_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr('sys.argv', [
        'serve', '--device', 'cpu', '--arch', 'deepseek-v2-lite-16b',
        '--requests', '3', '--new-tokens', '3', '--chunk-size', '4',
        '--prefix-cache', '--page-size', '8', '--shared-prefix', '16',
        '--fused-gather-rope', '--attn-backend', 'cuda'])
    serve.main()
    out = capsys.readouterr().out
    assert '3 requests, 9 new tokens' in out and 'prefix cache: ' in out
