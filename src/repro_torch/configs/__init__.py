"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

A copy of ``repro.configs`` restricted to the architectures the port serves
so far. Every module defines ``config()`` (exact published dims) and
``smoke_config()`` (reduced, for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.config import ModelConfig

# the paper's serial example (sliding window), an all-global GQA model for
# the paged KV pool, an MLA + MoE model (latent caches, expert FFN) and the
# paper's parallel example (LayerNorm, MHA; the FFN and the skip fold into
# the table), and gemma3 (5:1 local/global, two RoPE thetas, qk_norm folded
# into the table, head width 256 in the 1b), the encoder families: whisper
# (an encoder-decoder with cross-attention; learned decoder positions block
# the table) and its RoPE variant (the paper's 4-layer example), and
# internvl2-1b (a VLM: the hybrid table), mixtral-8x7b (a serial MoE
# block: the table folds Q/K/V only), its parallel twin (the paper's §3
# third column: the whole expert FFN folds into the table) and llama3-405b
# (128 q heads over 8 kv heads: 136 rotated heads in a table row), and
# the recurrent and hybrid families: xlstm-125m (mLSTM / sLSTM blocks, no
# positions: the table folds the up-projection, values and gates) and
# hymba-1.5b (attention beside mamba heads, 128 meta tokens)
ALL_IDS: List[str] = ['mistral_7b', 'glm4_9b', 'deepseek_v2_lite_16b',
                      'pythia_6_9b', 'gemma3_1b', 'gemma3_27b',
                      'whisper_tiny', 'whisper_tiny_rope', 'internvl2_1b',
                      'mixtral_8x7b', 'mixtral_8x7b_parallel',
                      'llama3_405b', 'xlstm_125m', 'hymba_1_5b']


def _norm(name: str) -> str:
    return name.replace('-', '_').replace('.', '_')


def _module(name: str):
    key = _norm(name)
    if key not in ALL_IDS:
        raise NotImplementedError(
            f'{name!r} is not ported to repro_torch yet; ported: {ALL_IDS}')
    return importlib.import_module(f'repro_torch.configs.{key}')


def get_config(name: str) -> ModelConfig:
    cfg = _module(name).config()
    cfg.validate()
    return cfg


def get_smoke_config(name: str) -> ModelConfig:
    cfg = _module(name).smoke_config()
    cfg.validate()
    return cfg
