"""Parameters of the port: the JAX package's nested-dict tree, as tensors.

The tree has the layout of ``repro.models.transformer.lm_schema``:
``embed/table``, ``final_norm/scale``, ``lm_head/w`` (untied heads) and
``backbone/{layer0, body, tail}``, where ``body`` is a list over the pattern
slots whose leaves are stacked over ``layer_plan(cfg).reps`` and ``tail`` a
list of unstacked blocks. Dense weights are ``(d_in, d_out)``. The other
families add their own leaves (:func:`model_schema`): the encoder-decoder
``encoder/{proj_in, layers, final_norm}`` (its layers stacked) and, with
learned positions, ``pos_embed``; the VLM ``projector/{ln, fc1, fc2}``;
Hymba its meta tokens ``meta``. The recurrent blocks' leaves follow
``repro_torch.models.ssm`` (sLSTM's recurrent ``r_*`` (H, dh, dh) and the
convolutions' ``w`` (k, C) are ``fan_in``; mamba's ``a_log`` zeros and
``d_skip`` ones).

- :func:`from_numpy_tree` bridges a tree of numpy arrays (for example
  ``jax.tree.map(np.asarray, Model(cfg).init(key))``) into tensors — the
  tests feed both packages the same weights this way.
- :func:`init_params` makes random weights directly on a device from a
  seeded ``torch.Generator``, with the initialisers of
  ``repro/models/layers.py:init_params`` (``fan_in`` leaves take
  ``std = scale / sqrt(prod(shape[:-1]))`` over the full, possibly stacked,
  shape, exactly as there; a leaf whose spec names a dtype, such as the
  fp32 MoE router, keeps it). The numbers differ from JAX's (another
  generator); the distributions are the same.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import ParamSpec


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _to_tensor(arr: Any) -> torch.Tensor:
    a = np.array(arr)                        # a writable, contiguous copy
    if a.dtype.name == 'bfloat16':           # ml_dtypes: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_numpy_tree(tree, device: torch.device | str = 'cuda'):
    """Nested dicts/lists of arrays -> the same structure of tensors on
    ``device``, dtypes kept."""
    return _map(lambda arr: _to_tensor(arr).to(device), tree)


def lm_schema(cfg: ModelConfig) -> Dict:
    """ParamSpec tree of a decoder-only LM (the layout above; learned
    positions add ``pos_embed`` (max_seq_len, d), meta tokens ``meta``
    (num_meta_tokens, d))."""
    from repro_torch.models.blocks import block_schema
    from repro_torch.models.layers import (dense_schema, norm_schema,
                                           stack_schema)
    from repro_torch.models.transformer import layer_plan
    plan = layer_plan(cfg)
    backbone: Dict[str, Any] = {
        'layer0': block_schema(cfg, plan.kinds[0], plan.use_moe[0])}
    if plan.reps:
        backbone['body'] = [
            stack_schema(block_schema(cfg, k, plan.use_moe[1]), plan.reps)
            for k in plan.slots]
    if plan.n_tail:
        backbone['tail'] = [block_schema(cfg, plan.slots[i], plan.use_moe[-1])
                            for i in range(plan.n_tail)]
    sch: Dict[str, Any] = {
        'embed': {'table': ParamSpec((cfg.vocab_size, cfg.d_model), 'normal',
                                     0.02)},
        'final_norm': norm_schema(cfg.d_model, cfg.norm),
        'backbone': backbone,
    }
    if not cfg.tie_embeddings:
        sch['lm_head'] = dense_schema(cfg.d_model, cfg.vocab_size)
    if cfg.pos == 'learned':
        sch['pos_embed'] = ParamSpec((cfg.max_seq_len, cfg.d_model),
                                     'normal', 0.02)
    if cfg.num_meta_tokens:
        sch['meta'] = ParamSpec((cfg.num_meta_tokens, cfg.d_model),
                                'normal', 0.02)
    return sch


def model_schema(cfg: ModelConfig) -> Dict:
    """ParamSpec tree of ``cfg``'s family, as JAX's ``Model.schema``: the
    encoder-decoder (``'audio'``, ``models.encdec.encdec_schema``), the VLM
    (``'vlm'``: the LM plus its projector, ``models.vlm.vlm_schema``) or
    the decoder-only LM."""
    if cfg.arch_class == 'audio':
        from repro_torch.models.encdec import encdec_schema
        return encdec_schema(cfg)
    if cfg.arch_class == 'vlm':
        from repro_torch.models.vlm import vlm_schema
        return vlm_schema(cfg)
    return lm_schema(cfg)


# largest fp32 temporary of one random draw (elements): a leaf above it is
# drawn in slices along its leading (stacked) axis, straight into the leaf
DRAW_SLICE = 1 << 26


def init_params(cfg: ModelConfig, seed: int = 0,
                device: torch.device | str = 'cuda',
                dtype: torch.dtype | None = None):
    """Random weights made on ``device`` from ``torch.Generator(seed)``, in
    ``dtype`` (default: the config's dtype; a spec's own dtype wins).
    Leaves are drawn in schema order; each leaf is fp32 normal draws, cast
    into the leaf in slices of whole rows along its leading axis, first to
    last, each slice at most :data:`DRAW_SLICE` elements (or one row), so
    the fp32 temporary stays small beside multi-GB stacked expert
    weights."""
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(spec: ParamSpec) -> torch.Tensor:
        dt = getattr(torch, spec.dtype) if spec.dtype else dtype
        if spec.init == 'zeros':
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == 'ones':
            return torch.ones(spec.shape, dtype=dt, device=device)
        if spec.init == 'normal':
            std = spec.init_scale
        elif spec.init == 'fan_in':
            fan_in = spec.shape[0] if len(spec.shape) == 1 \
                else math.prod(spec.shape[:-1])
            std = spec.init_scale / math.sqrt(max(fan_in, 1))
        else:
            raise ValueError(spec.init)
        out = torch.empty(spec.shape, dtype=dt, device=device)
        row = math.prod(spec.shape[1:])
        step = max(1, DRAW_SLICE // max(row, 1))
        for i in range(0, spec.shape[0], step):
            part = out[i:i + step]
            part.copy_(torch.randn(part.shape, generator=gen,
                                   dtype=torch.float32, device=device)
                       .mul_(std))
        return out

    return _map(make, model_schema(cfg))


def tree_slice(tree, i: int):
    """Index ``i`` along the leading (stacked) axis of every leaf — views,
    so in-place updates of a slice land in the stacked tensor."""
    return _map(lambda x: x[i], tree)
