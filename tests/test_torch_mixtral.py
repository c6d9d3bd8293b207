"""mixtral-8x7b (serial MoE blocks, all layers windowed), the paper's
hypothetical parallel Mixtral (mixtral-8x7b-parallel: layer 0's whole
expert FFN folds into the table) and llama3-405b (all global, 128 q heads
over 8 kv heads at full width) in the port against the JAX package.

Configs: the smoke configs (2 layers, d 128, 8 q heads over 2 kv heads, 4
experts top-2, window 8), fp32, the same numpy weights in both packages
(``PRNGKey(0)``, norm scales drawn away from one). The engine cases run
the MoE configs at a capacity factor of 0.5 (``DROP_CF``), where experts
drop tokens; the smoke configs' 2.0 gives every expert room for every
token, so nothing drops.

- The table against JAX's ``build_precomputed_table``, the parallel
  Mixtral's ``s`` rows included (``x + MoE(LN2(x))``, the MoE over the
  whole vocabulary chunk without a lane mask), also at a chunk and
  capacity where rows drop: the same drops and rows as JAX's.
- ``Model.apply`` logits and aux loss against JAX's, baseline and with the
  table (the parallel Mixtral's table drops layer 0's MoE and its loss).
- Engines against JAX's engine: dense caches at chunk 1 (no table) and at
  chunk 4 (the table), the paged pool at chunk 4 with the table (ring
  pages for the Mixtrals, whose layers are all windowed; linear pages and
  a copy-on-write for llama3), with and without the fused gather-RoPE:
  greedy tokens, statuses, MoE drops and prefix hits equal.
- Inside the port, bitwise, on the parallel MoE block: a chunked prefill
  equals token-by-token steps (hidden states and caches), and packed
  prefill equals unpacked (tokens, ``score()`` logits and drops).
- ``launch/serve.py`` serves each on the CPU with ``--prefix-cache`` and
  ``--fused-gather-rope``.

Tolerance: ``tests/test_precompute_equivalence.py``'s atol 2e-4 / rtol
2e-3. Router logits come from seeded weights and inputs; ``torch.topk``
orders tied values unlike ``lax.top_k`` and no tie is seeded away, so a
tie would show as a routing difference beyond the tolerance.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_scenarios import perturbed
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.precompute import build_precomputed_table as jax_table
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.precompute import build_precomputed_table
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.models.moe import moe_apply
from repro_torch.params import from_numpy_tree
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.programs import PACKED

ARCHS = ['mixtral_8x7b', 'mixtral_8x7b_parallel', 'llama3_405b']
PAR = 'mixtral_8x7b_parallel'
TOL = dict(atol=2e-4, rtol=2e-3)
DROP_CF = 0.5
PS, MAX_SEQ, NEW = 8, 64, 5
# (paged, chunk, table) of each engine case
CASES = {'dense1': (False, 1, False), 'dense4': (False, 4, True),
         'paged4': (True, 4, True)}
_MEMO = {}


def _memo(key, make):
    if key not in _MEMO:
        _MEMO[key] = make()
    return _MEMO[key]


def _cfg(get, arch, cf=None):
    cfg = get(arch)
    if cf is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _models(arch, cf=None):
    """(JAX model, params, table, port model, params, table) on one set of
    weights; ``cf`` replaces the MoE's capacity factor."""
    def make():
        jm = JaxModel(_cfg(jax_smoke_config, arch, cf))
        npt = perturbed(jax.tree.map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0))))
        jp = jax.tree.map(jnp.asarray, npt)
        tm = Model(_cfg(get_smoke_config, arch, cf))
        tp = from_numpy_tree(npt, device='cpu')
        return jm, jp, jax_table(jp, jm.cfg), tm, tp, tm.build_table(tp)
    return _memo(('models', arch, cf), make)


# ------------------------------------------------------------------ table
@pytest.mark.parametrize('arch', ARCHS)
def test_table_matches_jax(arch):
    """Rows against JAX's table; the parallel Mixtral's first piece is
    ``x + MoE(LN2(x))`` over the whole vocabulary (one chunk, no lane
    mask), the others' the embedding itself."""
    _, _, jt, tm, tp, tt = _models(arch)
    assert tt.layout == jt.layout
    np.testing.assert_allclose(tt.table.numpy(), np.asarray(jt.table), **TOL)
    first = tt.split(tt.table)[tt.layout[0][0]]
    x = tp['embed']['table']
    if arch != PAR:
        assert tt.layout[0][0] == 'x' and torch.equal(first, x)
        return
    lay0 = tp['backbone']['layer0']
    f, drops = moe_apply(lay0['moe'], L.rmsnorm(
        x, lay0['ln2']['scale'])[None], tm.cfg)
    assert tt.layout[0][0] == 's' and int(drops) == 0
    torch.testing.assert_close(first, x + f[0], **TOL)
    assert not torch.allclose(first, x, **TOL)


def test_parallel_table_drops_match_jax():
    """At the drop capacity the MoE of every chunk drops slots (capacity
    ``capacity(chunk)``, no lane mask): at JAX's chunk of 8192 rows (the
    whole smoke vocabulary) and at 64 the port counts drops and its rows,
    dropped slots included, equal JAX's built at the same chunk; the two
    chunkings give different tables, so the chunk is part of the
    table."""
    jm, jp, _, tm, tp, _ = _models(PAR, DROP_CF)
    rows = {}
    for chunk in (8192, 64):
        tt, drops = build_precomputed_table(tp, tm.cfg, chunk=chunk,
                                            return_drops=True)
        jt = jax_table(jp, jm.cfg, chunk=chunk)
        assert drops > 0, chunk
        np.testing.assert_allclose(tt.table.numpy(), np.asarray(jt.table),
                                   **TOL, err_msg=f'chunk {chunk}')
        rows[chunk] = tt.table
    assert not torch.allclose(rows[64], rows[8192], **TOL)


# ------------------------------------------------------------ Model.apply
@pytest.mark.parametrize('arch', ARCHS)
def test_apply_matches_jax(arch):
    """B 2, S 16 (two rings' worth of the window 8), baseline and with the
    table: logits and aux loss within the tolerance of JAX's own run."""
    jm, jp, jt, tm, tp, tt = _models(arch)
    tok = np.random.default_rng(16).integers(
        0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    aux = {}
    for pre in (False, True):
        want, jaux = jm.apply(jp, {'tokens': jnp.asarray(tok)},
                              precomputed=jt if pre else None)
        got, taux = tm.apply(tp, {'tokens': torch.from_numpy(tok)},
                             precomputed=tt if pre else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f'precomputed {pre}')
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
        aux[pre] = float(taux)
    if tm.cfg.moe is None:
        assert aux == {False: 0.0, True: 0.0}
    elif arch == PAR:       # layer 0's MoE (and its loss) is in the table
        assert aux[True] < aux[False]
    else:
        assert aux[True] == pytest.approx(aux[False], abs=2e-4, rel=2e-3)


# ----------------------------------------------------------------- engines
def _prompts(vocab):
    """Wave 1: five prompts (more than the 4 slots) of 7-29 tokens, three
    on a shared 16-token prefix; wave 2: the first prompt again (a prefix
    or snapshot hit when paged) and its first 21 tokens, which stop inside
    a page that its first run cached (linear pages: a copy-on-write)."""
    rng = np.random.default_rng(3)
    pre = rng.integers(3, vocab, 16)
    tails = [rng.integers(3, vocab, n) for n in (13, 3, 2, 9, 7)]
    first = [np.concatenate([pre, t]) for t in tails[:3]] + tails[3:]
    first = [p.astype(np.int32) for p in first]
    return [first, [first[0].copy(), first[0][:21].copy()]]


def _serve(eng, req_cls, score=False):
    """Both waves -> (greedy tokens, statuses, MoE drops, prefix hits[,
    score() logits of two prompts])."""
    waves = _prompts(eng.model.cfg.vocab_size)
    reqs = []
    for w, prompts in enumerate(waves):
        wave = [req_cls(uid=10 * w + i, prompt=p, max_new_tokens=NEW)
                for i, p in enumerate(prompts)]
        for r in wave:
            eng.submit(r)
        eng.run()
        reqs += wave
    st = eng.stats(reqs)
    out = ([list(r.generated) for r in reqs], [r.status.name for r in reqs],
           st['moe_token_drops'], [r.prefix_hit_tokens for r in reqs])
    if score:
        out += ([s.tobytes() for s in eng.score(waves[0][:2])],)
    return out


def _engine(cls, model, params, table, case, **kw):
    paged, chunk, pre = CASES[case]
    if paged:
        kw.update(prefix_cache=True, page_size=PS)
    return cls(model, params, max_slots=4, max_seq=MAX_SEQ, chunk_size=chunk,
               precomputed=table if pre else None, **kw)


def _jax_engine(arch, case):
    def make():
        jm, jp, jt = _models(arch, DROP_CF)[:3]
        return _serve(_engine(JaxEngine, jm, jp, jt, case,
                              attn_backend='reference'), JaxRequest)
    return _memo(('engine', arch, case), make)


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('arch', ARCHS)
def test_engine_matches_jax(arch, case):
    """The port's engine (cuda backend: the kernels' plain versions, the
    fused page writes and deferred clears) against JAX's engine (reference
    backend, the unfused table read): greedy tokens, statuses, MoE drops
    and prefix hits equal; with the table, with and without the fused
    gather-RoPE."""
    _, _, _, tm, tp, tt = _models(arch, DROP_CF)
    want = _jax_engine(arch, case)
    assert set(want[1]) == {'FINISHED'}
    if tm.cfg.moe is not None and case != 'dense1':
        assert want[2] > 0, 'the case should drop tokens'
    if CASES[case][0]:
        assert want[3][:5] == [0] * 5 and want[3][5] > 0 and want[3][6] > 0
    for fused in ((False, True) if CASES[case][2] else (False,)):
        eng = _engine(ServingEngine, tm, tp, tt, case, attn_backend='cuda',
                      device='cpu', fused_gather_rope=fused)
        assert _serve(eng, Request) == want, (case, fused)
        # ring pages hit only at snapshots: no copy-on-write
        assert (eng.cow_copies > 0) == (case == 'paged4'
                                        and arch == 'llama3_405b')


# ------------------------------------------- the parallel MoE, bitwise
@pytest.mark.parametrize('table', [False, True])
def test_parallel_chunked_equals_token_by_token(table):
    """The parallel Mixtral at its own capacity factor (no drops): a
    chunked prefill (chunk 4) writes the same ring caches and gives the
    same hidden states as token-by-token steps, bit for bit; with the
    table layer 0 is ``s + attn`` alone."""
    _, _, _, tm, tp, tt = _models(PAR)
    B, S, T = 2, 20, 4
    toks = np.random.default_rng(8).integers(0, 503, (B, S)).astype(np.int32)
    pre = tt if table else None

    def states():
        return tm.make_states(B, S, torch.float32, chunk=T, device='cpu')
    one, h_one = states(), []
    for p in range(S):
        h, one = tm.decode_step(tp, torch.from_numpy(toks[:, p:p + 1]), one,
                                torch.full((B,), p, dtype=torch.int32),
                                precomputed=pre, attn_backend='reference',
                                return_hidden=True)
        h_one.append(h)
    ch, h_ch = states(), []
    for p in range(0, S, T):
        h, ch = tm.decode_step(
            tp, torch.from_numpy(toks[:, p:p + T]), ch,
            torch.full((B,), p, dtype=torch.int32),
            n_valid=torch.full((B,), T, dtype=torch.int32), precomputed=pre,
            attn_backend='reference', return_hidden=True)
        h_ch.append(h)
    assert torch.equal(torch.cat(h_ch, dim=1), torch.cat(h_one, dim=1))
    for a, b in zip(jax.tree_util.tree_leaves(ch),
                    jax.tree_util.tree_leaves(one)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('paged', [False, True])
def test_parallel_packed_bitwise_unpacked(paged):
    """The parallel Mixtral at the drop capacity, chunk 4, the table and
    the fused gather: the packed engine's greedy tokens, statuses, drops,
    prefix hits and ``score()`` logits are bitwise the unpacked engine's
    (its MoE takes the slot-major capacity and canonical lane order), and
    packed steps ran."""
    _, _, _, tm, tp, tt = _models(PAR, DROP_CF)
    out = {}
    for pack in (False, True):
        eng = _engine(ServingEngine, tm, tp, tt,
                      'paged4' if paged else 'dense4', attn_backend='cuda',
                      device='cpu', fused_gather_rope=True,
                      pack_prefill=pack)
        out[pack] = _serve(eng, Request, score=True)
        assert any(k[0] == PACKED for k in eng.programs) == pack
    assert out[True] == out[False]
    assert out[False][2] > 0


# --------------------------------------------------------------------- CLI
@pytest.mark.parametrize('arch', ['mixtral-8x7b', 'mixtral-8x7b-parallel',
                                  'llama3-405b'])
def test_serve_cli_on_cpu(arch, monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr('sys.argv', [
        'serve', '--device', 'cpu', '--arch', arch, '--requests', '3',
        '--new-tokens', '3', '--chunk-size', '4', '--prefix-cache',
        '--page-size', '8', '--shared-prefix', '16', '--fused-gather-rope'])
    serve.main()
    out = capsys.readouterr().out
    assert '3 requests, 9 new tokens' in out and 'prefix cache: ' in out
