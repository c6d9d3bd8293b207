"""The port's copy of the paper's §3 accounting (``repro_torch.core.analysis``
and ``models.moe.moe_num_weights``) against the JAX package's, for every
configuration the port serves (``configs.ALL_IDS``): pure Python on each
package's own configs, ``preproj_layout`` and ``layer_plan``, so the
numbers are equal exactly.

mixtral-8x7b-parallel is the paper's third column: its table folds layer
0's whole expert FFN, so the read reduction at batch 1 rounds to
140,084x and the net memory delta is negative (the table grows by less
than the weights it removes).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import pytest

from repro.configs import get_config as jax_config
from repro.core import analysis as JAN
from repro.models.moe import moe_num_weights as jax_moe_num_weights
from repro_torch.configs import ALL_IDS, get_config
from repro_torch.core import analysis as AN
from repro_torch.models.moe import moe_num_weights


@pytest.mark.parametrize('name', ALL_IDS)
def test_analysis_matches_jax(name):
    cfg, jcfg = get_config(name), jax_config(name)
    got, want = AN.analyze(cfg), JAN.analyze(jcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert AN.weight_counts(cfg).as_dict() == \
        JAN.weight_counts(jcfg).as_dict()
    assert AN.eliminated_weights(cfg) == JAN.eliminated_weights(jcfg)
    assert AN.max_relative_savings(cfg) == JAN.max_relative_savings(jcfg)
    for batch in (1, 4, 64):
        assert got.reduction_factor(batch, cfg.d_model) == \
            want.reduction_factor(batch, jcfg.d_model)
    if cfg.moe is not None:
        assert moe_num_weights(cfg) == jax_moe_num_weights(jcfg)


def test_paper_columns():
    """The read reductions at batch 1 of the paper's three columns and of
    llama3-405b, and the parallel Mixtral's net memory decrease."""
    ratio = {n: AN.analyze(get_config(n)).reduction_factor(1, get_config(
        n).d_model) for n in ('mistral_7b', 'pythia_6_9b',
                              'mixtral_8x7b_parallel', 'llama3_405b')}
    assert round(ratio['mixtral_8x7b_parallel']) == 140084
    assert round(ratio['mistral_7b']) == 2458
    assert round(ratio['pythia_6_9b']) == 11264
    assert round(ratio['llama3_405b']) == 8674
    par = AN.analyze(get_config('mixtral_8x7b_parallel'))
    assert par.eliminated_weights == 1_434_451_968
    assert par.reads_without_b1 == 1_434_456_064
    assert par.reads_with_b1 == 10_240
    assert par.net_memory_delta < 0
    assert round(par.rel_memory_delta * 100, 2) == -2.65
