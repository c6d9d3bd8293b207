"""The full-sequence forward of MLA and MoE blocks in the port against the
JAX package, on deepseek-v2-lite-16b's smoke config (MLA attention, a dense
layer 0, then MoE layers with shared experts) in fp32, from the same
(bridged) weights and numpy inputs made with a seed.

- ``mla.mla_full`` (the non-absorbed form) with and without precomputed
  latents, against JAX's ``mla_full``.
- The MoE's load-balance aux loss (``moe_apply(with_aux=True)``) against
  JAX's ``moe_apply``, both router modes, without and with a lane mask
  (its means then run over the real lanes only), with and without
  capacity overflow; the output and drops as without the loss.
- ``Model.apply`` logits and aux loss against JAX's, baseline and with the
  table; inside the port, the table's forward against the baseline's.
- The decode path computes no aux loss: the decode step and the engine run
  with ``load_balance_loss`` made to raise.

Tolerance: ``tests/test_precompute_equivalence.py``'s atol 2e-4 / rtol
2e-3. Router logits come from standard-normal inputs and seeded weights:
``torch.topk`` orders tied values unlike ``lax.top_k``, and no tie is
seeded away, so a tie would show as a routing difference beyond the
tolerance, not be hidden by it.
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
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_smoke_config
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.model import Model
from repro_torch.params import from_numpy_tree
from repro_torch.serving import Request, ServingEngine

ARCH = 'deepseek_v2_lite_16b'
TOL = dict(atol=2e-4, rtol=2e-3)
_MEMO = {}


def _models():
    """(JAX model, params, table, port model, params, table) on one set of
    weights, norm scales drawn away from one; made once."""
    if 'm' not in _MEMO:
        jm = JaxModel(jax_smoke_config(ARCH))
        npt = perturbed(jax.tree.map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0))))
        jp = jax.tree.map(jnp.asarray, npt)
        tm = Model(get_smoke_config(ARCH))
        tp = from_numpy_tree(npt, device='cpu')
        _MEMO['m'] = (jm, jp, jm.build_table(jp), tm, tp, tm.build_table(tp))
    return _MEMO['m']


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------- mla_full
@pytest.mark.parametrize('latents', [False, True])
def test_mla_full_matches_jax(latents):
    """Layer 1's MLA weights over random normed inputs at B 2, S 12, with
    positions that start at 3 (not 0): from x_normed, and from latents
    computed by each package's ``compute_latents``."""
    jm, jp, _, tm, tp, _ = _models()
    cfg = tm.cfg
    jatt = jp['backbone']['body'][0]['attn']
    jatt = jax.tree.map(lambda a: a[0], jatt)
    tatt = jax.tree.map(lambda t: t[0], tp['backbone']['body'][0]['attn'])
    rng = np.random.default_rng(4)
    B, S = 2, 12
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 3 + S, dtype=np.int32), (B, S))
    theta = cfg.rope_theta
    if latents:
        jl = JMLA.compute_latents(jatt, jnp.asarray(x), jm.cfg)
        tl = MLA.compute_latents(tatt, torch.from_numpy(x), cfg)
        want = JMLA.mla_full(jatt, None, jnp.asarray(pos), jm.cfg,
                             rope_theta=theta, latents=jl)
        got = MLA.mla_full(tatt, None, torch.from_numpy(pos.copy()), cfg,
                           rope_theta=theta, latents=tl)
    else:
        want = JMLA.mla_full(jatt, jnp.asarray(x), jnp.asarray(pos), jm.cfg,
                             rope_theta=theta)
        got = MLA.mla_full(tatt, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()), cfg,
                           rope_theta=theta)
    assert got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- aux loss
@pytest.mark.parametrize('mode', ['softmax_topk', 'topk_softmax'])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('cf', [None, 0.25])
def test_aux_loss_matches_jax(mode, masked, cf):
    """``moe_apply(with_aux=True)``: (y, aux, drops) against JAX's; y and
    drops equal those of the call without the loss, bitwise."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    if cf:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    jp = JL.init_params(JMOE.moe_schema(jcfg), jax.random.PRNGKey(2),
                        'float32')
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
    rng = np.random.default_rng(6)
    B, S = 4, 12
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    mask = None
    if masked:
        n_valid = rng.integers(0, S + 1, B)
        n_valid[0], n_valid[-1] = S, 0
        mask = np.arange(S)[None] < n_valid[:, None]
    jy, jaux, jd = JMOE.moe_apply(jp, jnp.asarray(x), jcfg, router_mode=mode,
                                  lane_mask=None if mask is None
                                  else jnp.asarray(mask))
    tmask = None if mask is None else torch.from_numpy(mask)
    ty, taux, td = MOE.moe_apply(tp, torch.from_numpy(x), tcfg,
                                 router_mode=mode, lane_mask=tmask,
                                 with_aux=True)
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert int(td) == int(jd)
    assert (int(td) > 0) == bool(cf)
    y0, d0 = MOE.moe_apply(tp, torch.from_numpy(x), tcfg, router_mode=mode,
                           lane_mask=tmask)
    assert torch.equal(y0, ty) and int(d0) == int(td)


def test_aux_loss_masked_lanes_ignored():
    """With a lane mask the loss reads only the real lanes: garbage in the
    masked lanes leaves it unchanged, bitwise, and a mask of all lanes
    gives the unmasked loss."""
    tcfg = get_smoke_config(ARCH)
    jp = JL.init_params(JMOE.moe_schema(jax_smoke_config(ARCH)),
                        jax.random.PRNGKey(3), 'float32')
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(
        (3, 8, tcfg.d_model)).astype(np.float32))
    mask = torch.ones(3, 8, dtype=torch.bool)
    mask[:, 5:] = False
    x2 = x.clone()
    x2[:, 5:] = x2[:, 5:] * 50 + 3
    aux = [MOE.moe_apply(tp, t, tcfg, lane_mask=mask, with_aux=True)[1]
           for t in (x, x2)]
    assert torch.equal(aux[0], aux[1])
    full = MOE.moe_apply(tp, x, tcfg, lane_mask=torch.ones_like(mask),
                         with_aux=True)[1]
    torch.testing.assert_close(full, MOE.moe_apply(tp, x, tcfg,
                                                   with_aux=True)[1])


# ------------------------------------------------------------ Model.apply
@pytest.mark.parametrize('precomputed', [False, True])
def test_apply_matches_jax(precomputed):
    """deepseek-v2-lite-16b's ``Model.apply`` at B 2, S 16: logits and the
    aux loss (summed over the MoE layers) against JAX's."""
    jm, jp, jt, tm, tp, tt = _models()
    tok = _tokens(tm.cfg, 2, 16)
    want, jaux = jm.apply(jp, {'tokens': jnp.asarray(tok)},
                          precomputed=jt if precomputed else None)
    got, aux = tm.apply(tp, {'tokens': torch.from_numpy(tok)},
                        precomputed=tt if precomputed else None)
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_table_equals_baseline():
    """The paper's contract inside the port: the table's forward gives the
    baseline's logits and aux loss (layer 0 is dense, so its rows change
    no MoE input beyond rounding)."""
    _, _, _, tm, tp, tt = _models()
    tok = torch.from_numpy(_tokens(tm.cfg, 1, 24, seed=5))
    base, aux0 = tm.apply(tp, {'tokens': tok})
    pre, aux1 = tm.apply(tp, {'tokens': tok}, precomputed=tt)
    torch.testing.assert_close(pre, base, **TOL)
    torch.testing.assert_close(aux1, aux0, **TOL)


def test_decode_runs_no_aux_loss(monkeypatch):
    """The aux loss is the full forward's alone: a chunked decode step and
    an engine run (the cuda backend's plain versions) never call
    ``load_balance_loss``."""
    _, _, _, tm, tp, tt = _models()

    def refuse(*a, **k):
        raise AssertionError('the decode path computed the aux loss')
    monkeypatch.setattr(MOE, 'load_balance_loss', refuse)
    tok = _tokens(tm.cfg, 2, 4)
    st = tm.make_states(2, 16, torch.float32, chunk=4, device='cpu')
    tm.decode_step(tp, torch.from_numpy(tok), st,
                   torch.zeros(2, dtype=torch.int32),
                   n_valid=torch.tensor([4, 2], dtype=torch.int32),
                   precomputed=tt, attn_backend='cuda')
    eng = ServingEngine(tm, tp, max_slots=2, max_seq=32, chunk_size=4,
                        precomputed=tt, attn_backend='cuda', device='cpu',
                        dtype=torch.float32)
    req = Request(uid=0, prompt=_tokens(tm.cfg, 1, 9)[0], max_new_tokens=3)
    eng.submit(req)
    eng.run()
    assert req.status.name == 'FINISHED' and len(req.generated) == 3
    with pytest.raises(AssertionError, match='aux loss'):
        tm.apply(tp, {'tokens': torch.from_numpy(tok)})
