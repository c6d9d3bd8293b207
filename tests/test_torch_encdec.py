"""The encoder-decoder (whisper-tiny, whisper-tiny-rope) in the port
(``repro_torch.models.encdec``) against the JAX package, on the smoke
configs in fp32 with the same (bridged) weights: ``PRNGKey(0)``, with every
norm scale drawn as 1 + 0.1 N(0, 1) and every bias (norms and the
encoder's ``proj_in``) as 0.1 N(0, 1), so that no leaf is the identity.

- ``encoder_apply`` and ``prefill_cross_cache`` on seeded frames.
- ``Model.apply`` (``encdec_apply``), and with the table for
  whisper-tiny-rope (layer 0's self-attention Q/K/V from the rows).
- The example's sequence (``examples/whisper_decode.py``): the encoder,
  the cross K/V put into fresh states, 12 greedy steps from BOS: logits
  within atol 2e-4 / rtol 2e-3 of JAX's every step, greedy tokens equal,
  the self caches' positions equal.
- The table refused for whisper-tiny (learned positions, paper §2).
- The port's engine serving as ``tests/test_serving.py::
  test_audio_engine_still_serves`` does (zero cross K/V, chunk 1, dense
  caches): tokens equal to JAX's engine; its rules: ``prefix_cache`` and
  the ``cuda`` backend raise ``ValueError``, ``'auto'`` resolves to
  ``reference`` (JAX's ``'auto'`` off a TPU), chunk 1, no packing.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import encdec as JE
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import encdec as E
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import Request, ServingEngine
from _torch_scenarios import perturbed

TOL = dict(atol=2e-4, rtol=2e-3)
B, STEPS, MAX_SEQ, BOS = 2, 12, 32, 1
CASES = [('whisper_tiny', False), ('whisper_tiny_rope', False),
         ('whisper_tiny_rope', True)]
_MEMO = {}


def _models(arch):
    """(JAX model, JAX params, JAX table or None, port model, port params,
    port table or None) on one set of weights."""
    if arch not in _MEMO:
        jm = JaxModel(jax_smoke_config(arch))
        tree = perturbed(jm.init(jax.random.PRNGKey(0)))
        jp = jax.tree.map(jnp.asarray, tree)
        tm = Model(get_smoke_config(arch))
        tp = from_numpy_tree(tree, device='cpu')
        table = jm.cfg.precompute_supported
        _MEMO[arch] = (jm, jp, jm.build_table(jp) if table else None,
                       tm, tp, tm.build_table(tp) if table else None)
    return _MEMO[arch]


def _inputs(cfg):
    rng = np.random.default_rng(1)
    frames = rng.standard_normal(
        (B, cfg.encoder.source_len, cfg.encoder.frontend_dim)) \
        .astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, 9)).astype(np.int32)
    return frames, tokens


@pytest.fixture(scope='module')
def jax_runs():
    """JAX's encoder output, cross K/V, apply logits and the example's
    12-step decode (logits and positions a step), per (arch, table)."""
    memo = {}

    def get(arch, table):
        if (arch, table) in memo:
            return memo[arch, table]
        jm, jp, jt, _, _, _ = _models(arch)
        cfg = jm.cfg
        t = jt if table else None
        frames, tokens = _inputs(cfg)
        enc = jax.jit(lambda p, f: JE.encoder_apply(p, f, cfg))(
            jp['encoder'], jnp.asarray(frames))
        xkv = jax.jit(lambda p, e: JE.prefill_cross_cache(p, e, cfg))(
            jp, enc)
        logits, _ = jax.jit(lambda p, b: jm.apply(p, b, precomputed=t))(
            jp, {'tokens': jnp.asarray(tokens),
                 'frames': jnp.asarray(frames)})
        st = jm.make_states(B, MAX_SEQ, jnp.float32)
        st['layer0']['xk'], st['layer0']['xv'] = xkv['layer0']
        if 'body' in xkv:
            st['body'][0]['xk'], st['body'][0]['xv'] = xkv['body'][0]
        step = jax.jit(lambda p, tok, s, pos: jm.decode_step(
            p, tok, s, pos, precomputed=t))
        tok, steps = jnp.full((B, 1), BOS, jnp.int32), []
        for i in range(STEPS):
            lg, st = step(jp, tok, st, jnp.full((B,), i, jnp.int32))
            tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
            steps.append((np.asarray(lg), np.asarray(tok),
                          [np.asarray(x) for x in _self_pos(st)]))
        memo[arch, table] = dict(
            enc=np.asarray(enc), logits=np.asarray(logits), steps=steps,
            xkv=jax.tree.map(np.asarray, xkv))
        return memo[arch, table]
    return get


def _self_pos(states):
    """The self caches' position leaves: layer 0, the stacked body, the
    tail (JAX nests them under 'self', the port keeps them flat)."""
    out = []
    for part in ('layer0', 'body', 'tail'):
        if part not in states:
            continue
        layers = states[part] if isinstance(states[part], list) \
            else [states[part]]
        for st in layers:
            out.append(st['self']['pos'] if 'self' in st else st['pos'])
    return out


@pytest.mark.parametrize('arch', ['whisper_tiny', 'whisper_tiny_rope'])
def test_encoder_and_cross_cache_match_jax(arch, jax_runs):
    """``encoder_apply`` (the biased projector, sinusoidal positions, the
    stacked bidirectional layers) and ``prefill_cross_cache`` (layer 0,
    the stacked body) on seeded frames."""
    _, _, _, tm, tp, _ = _models(arch)
    want = jax_runs(arch, False)
    frames, _ = _inputs(tm.cfg)
    enc = E.encoder_apply(tp['encoder'], torch.from_numpy(frames), tm.cfg)
    np.testing.assert_allclose(enc.numpy(), want['enc'], **TOL)
    got = E.prefill_cross_cache(tp, enc, tm.cfg)
    assert sorted(got) == sorted(want['xkv'])
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree.map(lambda x: x.numpy(), got)),
            jax.tree_util.tree_leaves(want['xkv'])):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize('arch,table', CASES)
def test_apply_matches_jax(arch, table, jax_runs):
    """``Model.apply`` with ``batch['frames']``: logits within TOL; with
    the table (whisper-tiny-rope) also within TOL of the baseline."""
    _, _, _, tm, tp, tt = _models(arch)
    frames, tokens = _inputs(tm.cfg)
    batch = {'tokens': torch.from_numpy(tokens),
             'frames': torch.from_numpy(frames)}
    logits, aux = tm.apply(tp, batch, precomputed=tt if table else None)
    assert logits.shape == (B, tokens.shape[1], tm.cfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(),
                               jax_runs(arch, table)['logits'], **TOL)
    if table:
        base, _ = tm.apply(tp, batch)
        np.testing.assert_allclose(logits.numpy(), base.numpy(), **TOL)


@pytest.mark.parametrize('arch,table', CASES)
def test_decode_matches_jax(arch, table, jax_runs):
    """The example's sequence: encoder, cross K/V put into fresh states
    (``put_cross_cache``, in place), 12 greedy steps from BOS through
    ``Model.decode_step`` (``attn_backend='auto'``: the reference on the
    CPU) — logits within TOL of JAX's every step, greedy tokens equal, the
    self caches' positions equal."""
    _, _, _, tm, tp, tt = _models(arch)
    want = jax_runs(arch, table)
    frames, _ = _inputs(tm.cfg)
    enc = E.encoder_apply(tp['encoder'], torch.from_numpy(frames), tm.cfg)
    st = tm.make_states(B, MAX_SEQ, torch.float32, device='cpu')
    leaves = [x.data_ptr() for x in jax.tree_util.tree_leaves(st)]
    E.put_cross_cache(st, E.prefill_cross_cache(tp, enc, tm.cfg))
    tok = torch.full((B, 1), BOS, dtype=torch.int32)
    for i, (lg_w, tok_w, pos_w) in enumerate(want['steps']):
        lg, st = tm.decode_step(tp, tok, st,
                                torch.full((B,), i, dtype=torch.int32),
                                precomputed=tt if table else None)
        np.testing.assert_allclose(lg.numpy(), lg_w, **TOL)
        tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), tok_w)
        for got, w in zip(_self_pos(st), pos_w):
            np.testing.assert_array_equal(got.numpy(), w)
    # every leaf written in place
    assert [x.data_ptr() for x in jax.tree_util.tree_leaves(st)] == leaves


def test_table_refused_for_whisper_tiny():
    """Learned positions sit between the embedding and Q/K/V (paper §2,
    Fig. 2a): ``build_table`` refuses, as JAX's does."""
    jm, jp, _, tm, tp, _ = _models('whisper_tiny')
    assert not tm.cfg.precompute_supported and tm.cfg.pos == 'learned'
    with pytest.raises(AssertionError, match='precondition'):
        tm.build_table(tp)
    with pytest.raises(AssertionError, match='precondition'):
        jm.build_table(jp)


def _serve(eng, req_cls):
    reqs = [req_cls(uid=i, prompt=np.arange(3, 8) + i, max_new_tokens=4)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    assert eng.stats(reqs)['moe_token_drops'] == 0
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize('arch,table', [('whisper_tiny', False),
                                        ('whisper_tiny_rope', True)])
def test_engine_matches_jax_engine(arch, table):
    """3 requests on 2 slots (``test_audio_engine_still_serves``'s
    traffic), zero cross K/V: greedy tokens equal to JAX's engine's, with
    the table for whisper-tiny-rope."""
    jm, jp, jt, tm, tp, tt = _models(arch)
    want = _serve(JaxEngine(jm, jp, max_slots=2, max_seq=64,
                            precomputed=jt if table else None), JaxRequest)
    eng = ServingEngine(tm, tp, max_slots=2, max_seq=64, device='cpu',
                        precomputed=tt if table else None)
    assert _serve(eng, Request) == want


def test_audio_engine_rules(monkeypatch):
    """JAX's audio rules, and ``'auto'`` resolving to ``reference`` (in
    the engine and in ``Model.decode_step``) where the port's ``'auto'``
    would take ``cuda`` on a card; the launcher exits with JAX's
    message."""
    _, _, _, tm, tp, _ = _models('whisper_tiny')
    eng = ServingEngine(tm, tp, max_slots=2, max_seq=64, device='cpu',
                        chunk_size=4, pack_prefill=True)
    assert eng.chunk_size == 1 and not eng.pack_prefill
    assert eng.attn_backend.name == 'reference'
    with pytest.raises(ValueError, match='prefix caching'):
        ServingEngine(tm, tp, prefix_cache=True, device='cpu')
    with pytest.raises(ValueError, match='reference attention backend'):
        ServingEngine(tm, tp, attn_backend='cuda', device='cpu')
    st = tm.make_states(1, 8, torch.float32, device='cpu')
    args = (tp, torch.ones((1, 1), dtype=torch.int32), st,
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match='reference attention backend'):
        tm.decode_step(*args, attn_backend='cuda')
    _, _, stats = tm.decode_step(*args, return_stats=True)
    assert int(stats['moe_drops']) == 0
    with pytest.raises(AssertionError, match='one token per step'):
        tm.decode_step(*args, n_valid=torch.ones(1, dtype=torch.int32))
    with pytest.raises(AssertionError):
        tm.make_states(1, 8, device='cpu', num_pages=4, page_size=8)
    with pytest.raises(AssertionError):
        tm.paged_state_mask()
    from repro_torch.launch import serve
    monkeypatch.setattr('sys.argv', ['serve', '--device', 'cpu', '--arch',
                                     'whisper-tiny'])
    with pytest.raises(SystemExit,
                       match='use examples/whisper_transcribe.py for audio'):
        serve.main()
