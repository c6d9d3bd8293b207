"""The port's full-sequence forward (``Model.apply``, baseline and with the
precomputed table) against the JAX package, on the fp32 smoke configs of
mistral-7b (sliding window 8) and glm4-9b (all global), with the same
(bridged) weights.

- The attention cores: the port's ``naive_attention_core`` and
  ``blocked_attention_core`` (the flash kernel's plain version on the CPU)
  against JAX's (``block_q = block_k = 64``), with and without a window, and
  the port's blocked core against its own naive core.
- ``Model.apply`` against JAX's ``Model.apply`` at B 2, S 16 and at B 1,
  S 2048, which crosses ``BLOCKED_THRESHOLD`` into the blocked core: atol
  2e-4 / rtol 2e-3 (``tests/test_precompute_equivalence.py``'s bound).
- The port's own contracts: baseline logits equal precomputed logits (the
  paper's), and ``apply`` equals token-by-token ``decode_step`` with the
  table (atol 5e-4 / rtol 5e-3, as ``test_precompute_equivalence.py``).
- MLA / MoE blocks (deepseek-v2-lite-16b, the Mixtrals) are in
  ``tests/test_torch_moe_forward.py`` and ``tests/test_torch_mixtral.py``.

The kernels' plain versions against the JAX kernels, and their ``cuda``
twins, are in ``tests/test_torch_kernels.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm_qkv import rmsnorm_matmul
from repro_torch.models import attention as A
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree

ARCHS = ['mistral_7b', 'glm4_9b']
TOL = dict(atol=2e-4, rtol=2e-3)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)
_MODELS = {}


def _models(arch):
    """(JAX model, JAX params, JAX table, port model, port params, port
    table) on one set of weights, made once per arch."""
    if arch not in _MODELS:
        jm = JaxModel(jax_smoke_config(arch))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = Model(get_smoke_config(arch))
        tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
        _MODELS[arch] = (jm, jp, jm.build_table(jp), tm, tp,
                         tm.build_table(tp))
    return _MODELS[arch]


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _apply_both(arch, B, S, precomputed):
    jm, jp, jt, tm, tp, tt = _models(arch)
    tok = _tokens(tm.cfg, B, S)
    want, jaux = jm.apply(jp, {'tokens': jnp.asarray(tok)},
                          precomputed=jt if precomputed else None)
    got, aux = tm.apply(tp, {'tokens': torch.from_numpy(tok)},
                        precomputed=tt if precomputed else None)
    assert aux.dtype == torch.float32 and aux.shape == () and aux == 0
    assert float(jaux) == 0.0
    return got, np.asarray(want)


# ------------------------------------------------------------------ cores
def _qkv(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, cfg.q_size)).astype(np.float32)
    k = rng.standard_normal((B, S, cfg.kv_size)).astype(np.float32)
    v = rng.standard_normal((B, S, cfg.kv_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return q, k, v, pos


@pytest.mark.parametrize('arch,window', [('mistral_7b', 8),
                                         ('mistral_7b', 40),
                                         ('glm4_9b', 0)])
@pytest.mark.parametrize('S', [64, 200])
def test_attention_cores_match_jax(arch, window, S):
    """Naive and blocked cores (RoPE included) equal JAX's; the blocked
    core equals the naive one; S 200 is not a multiple of 64."""
    cfg = get_smoke_config(arch)
    jcfg = jax_smoke_config(arch)
    q, k, v, pos = _qkv(cfg, 2, S)
    kw = dict(rope_theta=cfg.rope_theta, window=window)
    jargs = tuple(map(jnp.asarray, (q, k, v, pos)))
    targs = tuple(map(torch.from_numpy, (q, k, v, pos)))
    j_naive = np.asarray(JA.naive_attention_core(*jargs, jcfg, **kw))
    j_blocked = np.asarray(JA.blocked_attention_core(
        *jargs, jcfg, block_q=64, block_k=64, **kw))
    t_naive = A.naive_attention_core(*targs, cfg, **kw)
    t_blocked = A.blocked_attention_core(*targs, cfg, **kw)
    np.testing.assert_allclose(t_naive.numpy(), j_naive, **TOL)
    np.testing.assert_allclose(t_blocked.numpy(), j_blocked, **TOL)
    torch.testing.assert_close(t_blocked, t_naive, **TOL)


def test_attention_core_dispatch_threshold(monkeypatch):
    """S >= BLOCKED_THRESHOLD goes through the flash wrapper (its plain
    version here), shorter sequences through the naive core."""
    assert A.BLOCKED_THRESHOLD == JA.BLOCKED_THRESHOLD == 2048
    cfg = get_smoke_config('glm4_9b')
    calls = []

    def spy(q, *a, **kw):
        calls.append(q.shape[1])
        return flash_attention(q, *a, **kw)
    monkeypatch.setattr(A, 'flash_attention', spy)
    for S in (A.BLOCKED_THRESHOLD - 1, A.BLOCKED_THRESHOLD):
        q, k, v, pos = map(torch.from_numpy, _qkv(cfg, 1, S))
        A.attention_core(q, k, v, pos, cfg, rope_theta=cfg.rope_theta)
    assert calls == [A.BLOCKED_THRESHOLD]


# ------------------------------------------------------------ Model.apply
@pytest.mark.parametrize('precomputed', [False, True])
@pytest.mark.parametrize('arch', ARCHS)
def test_apply_matches_jax(arch, precomputed):
    got, want = _apply_both(arch, 2, 16, precomputed)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize('precomputed', [False, True])
@pytest.mark.parametrize('arch', ARCHS)
def test_apply_blocked_matches_jax(arch, precomputed):
    """S 2048: both frameworks take their blocked cores (the port's flash
    wrapper runs its plain version on the CPU)."""
    S = A.BLOCKED_THRESHOLD
    got, want = _apply_both(arch, 1, S, precomputed)
    assert got.shape == (1, S, get_smoke_config(arch).vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize('S', [16, A.BLOCKED_THRESHOLD])
@pytest.mark.parametrize('arch', ARCHS)
def test_apply_baseline_equals_precomputed(arch, S):
    """The paper's contract inside the port: the table changes no logit
    beyond fp32 rounding, on the naive and the blocked core."""
    _, _, _, tm, tp, tt = _models(arch)
    tok = torch.from_numpy(_tokens(tm.cfg, 2 if S == 16 else 1, S, seed=3))
    base, _ = tm.apply(tp, {'tokens': tok})
    pre, _ = tm.apply(tp, {'tokens': tok}, precomputed=tt)
    torch.testing.assert_close(pre, base, **TOL)


@pytest.mark.parametrize('arch', ARCHS)
def test_apply_equals_token_by_token_decode(arch):
    """Full-sequence logits equal one-token decode steps with the table."""
    _, _, _, tm, tp, tt = _models(arch)
    B, S = 2, 12
    tok = torch.from_numpy(_tokens(tm.cfg, B, S, seed=5))
    logits, _ = tm.apply(tp, {'tokens': tok})
    states = tm.make_states(B, S, dtype=torch.float32, device='cpu')
    steps = []
    for t in range(S):
        lg, states = tm.decode_step(tp, tok[:, t:t + 1], states,
                                    torch.full((B,), t, dtype=torch.int32),
                                    precomputed=tt)
        steps.append(lg)
    torch.testing.assert_close(torch.cat(steps, dim=1), logits,
                               **DECODE_TOL)


def test_apply_return_hidden_is_final_normed():
    """``return_hidden`` gives the final-normed states the head reads, as
    JAX's ``lm_apply``."""
    jm, jp, _, tm, tp, _ = _models('glm4_9b')
    tok = _tokens(tm.cfg, 2, 16)
    h, _ = tm.apply(tp, {'tokens': torch.from_numpy(tok)},
                    return_hidden=True)
    want, _ = jm.apply(jp, {'tokens': jnp.asarray(tok)}, return_hidden=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), **TOL)
    logits, _ = tm.apply(tp, {'tokens': torch.from_numpy(tok)})
    torch.testing.assert_close(h @ tp['lm_head']['w'], logits)


def test_apply_on_cpu_counts_no_launch():
    _, _, _, tm, tp, tt = _models('mistral_7b')
    tok = torch.from_numpy(_tokens(tm.cfg, 1, 16))
    before = (rmsnorm_matmul.launches, flash_attention.launches)
    tm.apply(tp, {'tokens': tok})
    tm.apply(tp, {'tokens': tok}, precomputed=tt)
    assert (rmsnorm_matmul.launches, flash_attention.launches) == before
