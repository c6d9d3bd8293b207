"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package
on the deepseek-v2-lite-16b smoke config in fp32, from the same (bridged)
weights and numpy inputs made with a seed: outputs within the bound of
``tests/test_precompute_equivalence.py`` (atol 2e-4, rtol 2e-3) and the
dropped-slot count exactly equal.

The inputs are standard normals, so router logits have no ties:
``torch.topk`` and ``lax.top_k`` order tied values differently, and a tie
would route a token to different experts in the two packages.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as MOE
from repro_torch.params import from_numpy_tree

TOL = dict(atol=2e-4, rtol=2e-3)


def _cfgs(**moe):
    jcfg, tcfg = (jax_smoke_config('deepseek_v2_lite_16b'),
                  get_smoke_config('deepseek_v2_lite_16b'))
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = JL.init_params(JMOE.moe_schema(jcfg), jax.random.PRNGKey(seed),
                        'float32')
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp), device='cpu')


def test_schema_matches_jax():
    jcfg, tcfg = _cfgs()
    jsch = JMOE.moe_schema(jcfg)
    tsch = MOE.moe_schema(tcfg)
    flat = lambda s: jax.tree_util.tree_leaves(  # noqa: E731
        s, is_leaf=lambda x: hasattr(x, 'shape'))
    assert [(x.shape, x.init, x.dtype) for x in flat(jsch)] == \
        [(x.shape, x.init, x.dtype) for x in flat(tsch)]
    assert tsch['router'].dtype == 'float32'


@pytest.mark.parametrize('n', [1, 4, 7, 64, 300])
def test_capacity_matches_jax(n):
    jcfg, tcfg = _cfgs()
    full = get_smoke_config('deepseek_v2_lite_16b')
    assert MOE.capacity(n, tcfg.moe) == JMOE.capacity(n, jcfg.moe)
    m = dataclasses.replace(full.moe, num_experts=64, top_k=6,
                            capacity_factor=1.25)
    assert MOE.capacity(n, m) == JMOE.capacity(n, m)


@pytest.mark.parametrize('mode', ['topk_softmax', 'softmax_topk'])
def test_router_probs_match_jax(mode):
    jcfg, tcfg = _cfgs(num_experts=8, top_k=3)
    logits = np.random.default_rng(2).standard_normal((20, 8)) \
        .astype(np.float32)
    jw, ji = JMOE.router_probs(jnp.asarray(logits), jcfg.moe, mode)
    tw, ti = MOE.router_probs(torch.from_numpy(logits), tcfg.moe, mode)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize('mode', ['softmax_topk', 'topk_softmax'])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('moe,B,S,expect_drops', [
    ({}, 3, 5, False),
    # capacity 8 slots per expert for 48 tokens x top-2 over 4 experts:
    # most of each expert's slots overflow
    ({'capacity_factor': 0.25}, 4, 12, True)])
def test_moe_apply_matches_jax(mode, masked, moe, B, S, expect_drops):
    """Outputs and dropped-slot counts, without and with a lane mask (chunk
    padding and a free slot), with and without capacity overflow."""
    jcfg, tcfg = _cfgs(**moe)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(B * S)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    mask = None
    if masked:
        n_valid = rng.integers(0, S + 1, B)
        n_valid[0], n_valid[-1] = S, 0
        mask = np.arange(S)[None] < n_valid[:, None]
    jy, _, jd = JMOE.moe_apply(jp, jnp.asarray(x), jcfg, router_mode=mode,
                               lane_mask=None if mask is None
                               else jnp.asarray(mask))
    ty, td = MOE.moe_apply(tp, torch.from_numpy(x), tcfg, router_mode=mode,
                           lane_mask=None if mask is None
                           else torch.from_numpy(mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert td.dtype == torch.int32 and int(td) == int(jd)
    assert (int(td) > 0) == expect_drops


def test_masked_lanes_take_no_capacity():
    """Under overflow, garbage in masked lanes changes neither the real
    tokens' outputs nor the drop count; masked rows are the shared
    experts' output alone."""
    _, tcfg = _cfgs(capacity_factor=0.25)
    jp, tp = _params(_cfgs(capacity_factor=0.25)[0])
    rng = np.random.default_rng(9)
    B, S, d = 4, 12, tcfg.d_model
    x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    mask = torch.ones(B, S, dtype=torch.bool)
    mask[:, 8:] = False
    y0, d0 = MOE.moe_apply(tp, x, tcfg, router_mode='softmax_topk',
                           lane_mask=mask)
    x2 = x.clone()
    x2[:, 8:] = torch.from_numpy(
        rng.standard_normal((B, S - 8, d)).astype(np.float32)) * 100
    y1, d1 = MOE.moe_apply(tp, x2, tcfg, router_mode='softmax_topk',
                           lane_mask=mask)
    assert int(d0) == int(d1) > 0
    assert torch.equal(y0[:, :8], y1[:, :8])
    from repro_torch.models.ffn import ffn_apply
    shared = ffn_apply(tp['shared'], x2[:, 8:], act='silu')
    assert torch.equal(y1[:, 8:], shared)
