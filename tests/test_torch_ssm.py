"""The recurrent modules of the port (``repro_torch.models.ssm``) against
the JAX package's ``repro.models.ssm``, in fp32 on the same (bridged)
weights: JAX's initialisers from ``PRNGKey(0)`` over each module's schema,
every norm scale and bias perturbed (``_torch_scenarios.perturbed``), and
the causal convolutions' biases too, so that no leaf is the identity.

Configs: xlstm-125m's and hymba-1.5b's smoke configs, and, for the
convolution and the property, the ``t-ssm`` config of
``tests/test_chunked_all_archs.py`` (one mLSTM layer, kernel 3).

- The causal convolution and its one-token step.
- mLSTM, sLSTM and the mamba heads: the full-sequence form from the
  initial state, the one-token step and the chunk step with ``n_valid``
  (padding lanes and ``n_valid = 0`` slots included), outputs and every
  state leaf within atol 2e-4 / rtol 2e-3.
- A property (hypothesis, 10 examples a module): the port's masked chunk
  scan equals sequential one-token steps on the same projections bitwise,
  on the valid lanes and in the state, and a slot with ``n_valid = 0``
  keeps its state bit for bit.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_scenarios import perturbed
from repro.config import ModelConfig as JaxConfig
from repro.config import SSMConfig as JaxSSM
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm as S
from repro_torch.params import from_numpy_tree

TOL = dict(atol=2e-4, rtol=2e-3)
B, SEQ, T = 3, 7, 4
NV = np.array([4, 2, 0], np.int32)        # a full, a short and an idle slot


def _t_ssm(cls, ssm_cls):
    return cls(name='t-ssm', arch_class='ssm', num_layers=1, d_model=16,
               num_heads=2, num_kv_heads=2, head_dim=8, d_ff=0,
               vocab_size=32, max_seq_len=64, pattern=('mlstm',), pos='none',
               dtype='float32',
               ssm=ssm_cls(conv_kernel=3, expand=2, num_ssm_heads=2))


def _configs(name):
    """(JAX config, port config) of ``name``."""
    if name == 't_ssm':
        return _t_ssm(JaxConfig, JaxSSM), _t_ssm(ModelConfig, SSMConfig)
    return jax_smoke_config(name), get_smoke_config(name)


# (config, module) pairs held against JAX; the module names its schema /
# preproj / init / apply / step functions in both packages
CASES = [('xlstm_125m', 'mlstm'), ('xlstm_125m', 'slstm'),
         ('hymba_1_5b', 'mamba')]
# ... and those of the chunk-scan property (t-ssm: kernel 3, two heads)
PROPERTY_CASES = [('t_ssm', 'mlstm')] + CASES
_MEMO = {}


def _module(name, mod):
    """(JAX config, JAX params, port config, port params) of one module."""
    if (name, mod) not in _MEMO:
        jcfg, tcfg = _configs(name)
        tree = jax.tree.map(np.asarray, JL.init_params(
            getattr(JS, f'{mod}_schema')(jcfg), jax.random.PRNGKey(0)))
        tree = perturbed(tree)
        _MEMO[name, mod] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                            from_numpy_tree(tree, device='cpu'))
    return _MEMO[name, mod]


def _xn(cfg, S_len, seed=2):
    """Pre-normed block input: d wide (mLSTM, sLSTM, mamba all take
    LN1(h) of width d)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S_len, cfg.d_model)).astype(np.float32)


def _state(cfg, mod, seed=3):
    """A state in the middle of a sequence: every leaf random (sLSTM's n
    kept positive, as its recurrence keeps it), as numpy arrays."""
    init = getattr(S, f'{mod}_init_state')(cfg, B, 'cpu')
    rng = np.random.default_rng(seed)
    out = {}
    for nm, x in init.items():
        a = rng.standard_normal(tuple(x.shape)).astype(np.float32) * 0.5
        out[nm] = np.abs(a) + 0.5 if (mod == 'slstm' and nm == 'n') else a
    return out


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **TOL)


@pytest.mark.parametrize('name,width,kernel', [('t_ssm', 32, 3),
                                               ('hymba_1_5b', 64, 4)])
def test_conv_matches_jax(name, width, kernel):
    """``causal_conv`` over a sequence and ``conv_step`` from a random
    buffer."""
    tree = perturbed(jax.tree.map(np.asarray, JL.init_params(
        JS.conv_schema(width, kernel), jax.random.PRNGKey(1))))
    jp, tp = jax.tree.map(jnp.asarray, tree), from_numpy_tree(tree, 'cpu')
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, SEQ, width)).astype(np.float32)
    buf = rng.standard_normal((B, kernel - 1, width)).astype(np.float32)
    _close(S.causal_conv(tp, torch.from_numpy(x)),
           JS.causal_conv(jp, jnp.asarray(x)), 'causal_conv')
    got, gbuf = S.conv_step(tp, torch.from_numpy(x[:, 0]),
                            torch.from_numpy(buf))
    want, wbuf = JS.conv_step(jp, jnp.asarray(x[:, 0]), jnp.asarray(buf))
    _close(got, want, 'conv_step')
    _close(gbuf, wbuf, 'conv_step buffer')


@pytest.mark.parametrize('name,mod', CASES)
def test_apply_matches_jax(name, mod):
    """The full-sequence form (``*_apply``) from the initial state."""
    jcfg, jp, tcfg, tp = _module(name, mod)
    xn = _xn(tcfg, SEQ)
    want = jax.jit(lambda p, x: getattr(JS, f'{mod}_apply')(p, x, jcfg))(
        jp, jnp.asarray(xn))
    got = getattr(S, f'{mod}_apply')(tp, torch.from_numpy(xn), tcfg)
    _close(got, want, f'{name} {mod} apply')


@pytest.mark.parametrize('chunked', [False, True], ids=['step', 'chunk'])
@pytest.mark.parametrize('name,mod', CASES)
def test_step_matches_jax(name, mod, chunked):
    """The one-token step, or the T-lane chunk with ``n_valid`` (4, 2, 0),
    from a random mid-sequence state: outputs on the valid lanes and every
    state leaf, which the port writes in place."""
    jcfg, jp, tcfg, tp = _module(name, mod)
    xn = _xn(tcfg, T if chunked else 1)
    st = _state(tcfg, mod)
    kw = dict(n_valid=NV) if chunked else {}
    want_y, want_st = jax.jit(lambda p, x, s, k: getattr(JS, f'{mod}_step')(
        p, x, s, jcfg, **k))(
        jp, jnp.asarray(xn), {k: jnp.asarray(v) for k, v in st.items()},
        {k: jnp.asarray(v) for k, v in kw.items()})
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    leaves = dict(tst)
    got_y, got_st = getattr(S, f'{mod}_step')(
        tp, torch.from_numpy(xn), tst, tcfg,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got_st is tst and all(got_st[k] is leaves[k] for k in leaves)
    for b in range(B):
        n = int(NV[b]) if chunked else 1
        _close(got_y[b, :n], want_y[b, :n], f'{name} {mod} y slot {b}')
    assert sorted(got_st) == sorted(want_st)
    for nm in want_st:
        _close(got_st[nm], want_st[nm], f'{name} {mod} state {nm}')
    if chunked:                             # the idle slot: untouched
        for nm in st:
            assert np.array_equal(got_st[nm][2].numpy(), st[nm][2])


@pytest.mark.parametrize('name,mod', PROPERTY_CASES)
@settings(max_examples=10, deadline=None)
@given(t=st.integers(1, 6), data=st.data())
def test_masked_chunk_scan_property(name, mod, t, data):
    """The port's masked chunk scan over t lanes with drawn ``n_valid``
    equals sequential one-token steps, each committed where ``i <
    n_valid``: the final state bitwise, the outputs on every slot's valid
    lanes bitwise, and a slot with ``n_valid = 0`` keeps its state bit for
    bit. Both take the chunk's position-wise projections (``pre``) from one
    ``*_preproj`` call, as the table path does: CPU BLAS may block a
    matmul of B*t rows otherwise than one of B rows."""
    _, _, cfg, tp = _module(name, mod)
    nv = np.array([data.draw(st.integers(0, t), label=f'n_valid[{b}]')
                   for b in range(B)], np.int32)
    xn = torch.from_numpy(_xn(cfg, t, seed=int(nv.sum()) + t))
    pre = getattr(S, f'{mod}_preproj')(tp, xn)
    st0 = _state(cfg, mod)
    step = getattr(S, f'{mod}_step')
    chunk = {k: torch.from_numpy(v.copy()) for k, v in st0.items()}
    y_chunk, _ = step(tp, None, chunk, cfg, pre=pre,
                      n_valid=torch.from_numpy(nv))
    seq = {k: torch.from_numpy(v.copy()) for k, v in st0.items()}
    ys = []
    for i in range(t):
        old = {k: v.clone() for k, v in seq.items()}
        y_i, _ = step(tp, None, seq, cfg,
                      pre={k: v[:, i:i + 1] for k, v in pre.items()})
        keep = torch.from_numpy(i < nv)
        for k in seq:
            seq[k].copy_(torch.where(
                keep.view((-1,) + (1,) * (seq[k].dim() - 1)), seq[k],
                old[k]))
        ys.append(y_i[:, 0])
    for k in seq:
        assert torch.equal(chunk[k], seq[k]), k
        for b in np.flatnonzero(nv == 0):
            assert np.array_equal(chunk[k][b].numpy(), st0[k][b]), k
    y_seq = torch.stack(ys, dim=1)
    for b in range(B):
        assert torch.equal(y_chunk[b, :nv[b]], y_seq[b, :nv[b]]), b
