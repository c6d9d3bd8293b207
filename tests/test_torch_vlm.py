"""The VLM (internvl2-1b) in the port (``repro_torch.models.vlm``) against
the JAX package, on the smoke config in fp32 with the same (bridged)
weights: ``PRNGKey(0)``, norm scales drawn as 1 + 0.1 N(0, 1) and the
projector's biases as 0.1 N(0, 1) (``_torch_scenarios.perturbed``).

- ``Model.apply`` with ``batch['patches']`` (the sequence ``[16 text |
  patches | rest of the text]``), the baseline and the *hybrid* table
  (text rows gathered, the patches' layer 0 on the fly): logits within
  atol 2e-4 / rtol 2e-3 of JAX's, and the hybrid within the same bound of
  the baseline inside the port.
- Serving text only, as JAX: the port's engine chunked (dense caches,
  chunk 4, the table with the fused gather-RoPE) and paged (radix cache,
  page 8), on the ``cuda`` backend's plain versions, against JAX's engine:
  greedy tokens and prefix hits equal.
- Inside the port: a chunked prefill gives the token-by-token steps'
  hidden states and caches bit for bit (G 7: 7 query heads over one kv
  head, the group size internvl2-1b's full width has).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import VLM_PREFIX, Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, ServingEngine
from _torch_scenarios import perturbed

ARCH = 'internvl2_1b'
TOL = dict(atol=2e-4, rtol=2e-3)
_MEMO = {}


def _models():
    """(JAX model, JAX params, JAX table, port model, port params, port
    table) on one set of weights."""
    if not _MEMO:
        jm = JaxModel(jax_smoke_config(ARCH))
        tree = perturbed(jm.init(jax.random.PRNGKey(0)))
        jp = jax.tree.map(jnp.asarray, tree)
        tm = Model(get_smoke_config(ARCH))
        tp = from_numpy_tree(tree, device='cpu')
        _MEMO['m'] = (jm, jp, jm.build_table(jp), tm, tp, tm.build_table(tp))
    return _MEMO['m']


def _batch(cfg, S_text=23, B=2):
    rng = np.random.default_rng(2)
    return {'tokens': rng.integers(0, cfg.vocab_size, (B, S_text))
            .astype(np.int32),
            'patches': rng.standard_normal(
                (B, cfg.encoder.source_len, cfg.encoder.frontend_dim))
            .astype(np.float32)}


@pytest.mark.parametrize('hybrid', [False, True])
def test_vlm_apply_matches_jax(hybrid):
    """Logits over the whole sequence (text and patches) within TOL of
    JAX's; the hybrid table's within TOL of the port's baseline."""
    jm, jp, jt, tm, tp, tt = _models()
    batch = _batch(tm.cfg)
    want, _ = jax.jit(lambda p, b: jm.apply(
        p, b, precomputed=jt if hybrid else None))(
        jp, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, aux = tm.apply(tp, tb, precomputed=tt if hybrid else None)
    S = batch['tokens'].shape[1] + tm.cfg.encoder.source_len
    assert got.shape == (2, S, tm.cfg.vocab_size) and float(aux) == 0.0
    assert VLM_PREFIX == 16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if hybrid:
        base, _ = tm.apply(tp, tb)
        np.testing.assert_allclose(got.numpy(), base.numpy(), **TOL)


def _serve(eng, req_cls, vocab):
    """Two waves on 2 slots: three prompts on a 16-token system prompt,
    then two more on it (prefix hits when paged). -> (tokens, hits)."""
    rng = np.random.default_rng(6)
    system = rng.integers(3, vocab, 16).astype(np.int32)
    reqs = []
    for wave in ((5, 11, 3), (9, 2)):
        batch = [req_cls(uid=len(reqs) + i, prompt=np.concatenate(
            [system, rng.integers(3, vocab, n).astype(np.int32)]),
            max_new_tokens=5) for i, n in enumerate(wave)]
        for r in batch:
            eng.submit(r)
        eng.run()
        reqs += batch
    assert all(r.done and len(r.generated) == 5 for r in reqs)
    return [list(r.generated) for r in reqs], \
        [r.prefix_hit_tokens for r in reqs]


@pytest.mark.parametrize('paged', [False, True])
def test_engine_matches_jax_engine(paged):
    """Text-only serving with the table: JAX's engine (reference backend,
    the plain gather) against the port's (the fused gather-RoPE and the
    ``cuda`` backend, whose kernel wrappers run their plain versions on
    the CPU): greedy tokens and prefix hits equal."""
    jm, jp, jt, tm, tp, tt = _models()
    kw = dict(max_slots=2, max_seq=64, chunk_size=4)
    if paged:
        kw.update(prefix_cache=True, page_size=8)
    want = _serve(JaxEngine(jm, jp, precomputed=jt,
                            attn_backend='reference', **kw),
                  JaxRequest, jm.cfg.vocab_size)
    eng = ServingEngine(tm, tp, precomputed=tt, fused_gather_rope=True,
                        attn_backend='cuda', device='cpu', **kw)
    assert eng.fused_gather_rope
    got = _serve(eng, Request, tm.cfg.vocab_size)
    assert got == want
    assert any(got[1]) == paged


def test_chunked_equals_token_by_token_bitwise():
    """With the table, reference backend: a chunked prefill (chunk 4) and
    token-by-token steps give the same hidden states and caches, bit for
    bit. (The tied head is one matmul of those states, which CPU BLAS may
    block differently at B*T rows than at B rows; the engine test above
    holds the tokens.)"""
    _, _, _, tm, tp, tt = _models()
    B, S, T = 2, 24, 4
    toks = np.random.default_rng(8).integers(0, tm.cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    out = {}
    for chunk in (1, T):
        st, hs = tm.make_states(B, S, torch.float32, chunk=T,
                                device='cpu'), []
        for p in range(0, S, chunk):
            kw = {} if chunk == 1 else dict(
                n_valid=torch.full((B,), T, dtype=torch.int32))
            h, st = tm.decode_step(
                tp, torch.from_numpy(toks[:, p:p + chunk]), st,
                torch.full((B,), p, dtype=torch.int32), precomputed=tt,
                attn_backend='reference', return_hidden=True, **kw)
            hs.append(h)
        out[chunk] = (torch.cat(hs, dim=1), jax.tree_util.tree_leaves(st))
    assert torch.equal(out[1][0], out[T][0])
    for a, b in zip(out[1][1], out[T][1]):
        assert torch.equal(a, b)
