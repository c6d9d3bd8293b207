"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``).

The mel-spectrogram + conv feature extractor is a stub, as in JAX: the model
consumes precomputed *frame embeddings* (B, frames, frontend_dim), and a
learned linear projector with a bias (``proj_in``) maps them to the encoder
width. The bidirectional encoder (sinusoidal positions, LayerNorm, plain
attention and a GELU MLP a layer), the causal decoder with cross-attention
and the decoder's learned absolute positions are real.

Paper relevance: faithful whisper adds learned positions between the
embedding and the Q/K/V projections, which blocks the table (paper §2,
Fig. 2a; ``precompute_supported=False``). ``whisper-tiny-rope`` swaps the
decoder to RoPE, and its table folds layer 0's self-attention Q/K/V
(``pre['q']``, ``pre['k']``, ``pre['v']``). The cross-attention, the FFN
and every other layer run at run time.

The encoder's attention and the cross-attention are plain matmuls, as they
are plain einsums outside any Pallas kernel in JAX. The decoder's
self-attention takes the reference backend (``attn_backend``): JAX's
enc-dec decode supports no other.

**States.** JAX nests a layer's self cache under ``'self'`` beside the
cross K/V (``{'self': {'k', 'v', 'pos'}, 'xk', 'xv'}``); here a layer's
state is one flat dict ``{'k', 'v', 'pos', 'xk', 'xv'}`` (the serving
engine's slot reset and bucket views walk flat dicts of leaves), the
``body`` leaves stacked over its layers. Caches are updated in place, as
everywhere in the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.attn_backend import REFERENCE
from repro_torch.models.blocks import block_schema
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.transformer import (embed_tokens, layer_plan,
                                            lm_head, lm_logits)
from repro_torch.params import tree_slice


# =============================================================== encoder
def encoder_layer_schema(cfg: ModelConfig) -> Dict:
    e = cfg.encoder
    d = e.d_model
    return {
        'ln1': L.norm_schema(d, cfg.norm),
        'wq': L.dense_schema(d, d),
        'wk': L.dense_schema(d, d),
        'wv': L.dense_schema(d, d),
        'wo': L.dense_schema(d, d),
        'ln2': L.norm_schema(d, cfg.norm),
        'ffn_up': L.dense_schema(d, e.d_ff),
        'ffn_down': L.dense_schema(e.d_ff, d),
    }


def encoder_schema(cfg: ModelConfig) -> Dict:
    e = cfg.encoder
    return {
        'proj_in': L.dense_schema(e.frontend_dim, e.d_model, bias=True),
        'layers': [L.stack_schema(encoder_layer_schema(cfg), e.num_layers)],
        'final_norm': L.norm_schema(e.d_model, cfg.norm),
    }


def _bidir_attention(p: Dict, xn: torch.Tensor, nheads: int) -> torch.Tensor:
    B, S, d = xn.shape
    hd = d // nheads
    q = L.dense(p['wq'], xn).reshape(B, S, nheads, hd)
    k = L.dense(p['wk'], xn).reshape(B, S, nheads, hd)
    v = L.dense(p['wv'], xn).reshape(B, S, nheads, hd)
    scores = torch.einsum('bqhd,bshd->bhqs', q.float(), k.float()) \
        * hd ** -0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum('bhqs,bshd->bqhd', probs, v).reshape(B, S, d)
    return L.dense(p['wo'], ctx)


@torch.no_grad()
def encoder_apply(params: Dict, frames: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """frames (B, T, frontend_dim) stub embeddings -> (B, T, enc_d): the
    projector, sinusoidal positions, then the stacked encoder layers (a
    loop over views of the stacked leaves in place of JAX's scan)."""
    e = cfg.encoder
    h = L.dense(params['proj_in'], frames.to(getattr(torch, cfg.dtype)))
    if e.pos == 'sincos':
        h = h + L.sincos_pos_embedding(h.shape[1], e.d_model,
                                       h.device).to(h.dtype)
    stacked = params['layers'][0]
    for i in range(stacked['wq']['w'].shape[0]):
        p = tree_slice(stacked, i)
        xn = L.norm_apply(p['ln1'], h, cfg.norm)
        h = h + _bidir_attention(p, xn, e.num_heads)
        xn2 = L.norm_apply(p['ln2'], h, cfg.norm)
        h = h + L.dense(p['ffn_down'],
                        L.activation('gelu')(L.dense(p['ffn_up'], xn2)))
    return L.norm_apply(params['final_norm'], h, cfg.norm)


# ======================================================== decoder w/ cross
def decoder_layer_schema(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    sch = block_schema(cfg, 'global', False)       # self-attn + ffn
    sch['ln_x'] = L.norm_schema(d, cfg.norm)
    enc_d = cfg.encoder.d_model
    sch['xattn'] = {
        'wq': L.dense_schema(d, cfg.q_size),
        'wk': L.dense_schema(enc_d, cfg.kv_size),
        'wv': L.dense_schema(enc_d, cfg.kv_size),
        'wo': L.dense_schema(cfg.attn_out_size, d),
    }
    return sch


def encdec_schema(cfg: ModelConfig) -> Dict:
    plan = layer_plan(cfg)
    assert plan.kinds[0] == 'global' and not plan.n_head
    sch: Dict[str, Any] = {
        'encoder': encoder_schema(cfg),
        'embed': {'table': L.ParamSpec((cfg.vocab_size, cfg.d_model),
                                       'normal', 0.02)},
        'final_norm': L.norm_schema(cfg.d_model, cfg.norm),
        'backbone': {'layer0': decoder_layer_schema(cfg)},
    }
    if plan.reps:
        sch['backbone']['body'] = [
            L.stack_schema(decoder_layer_schema(cfg), plan.reps)]
    if plan.n_tail:
        sch['backbone']['tail'] = [decoder_layer_schema(cfg)
                                   for _ in range(plan.n_tail)]
    if cfg.pos == 'learned':
        sch['pos_embed'] = L.ParamSpec((cfg.max_seq_len, cfg.d_model),
                                       'normal', 0.02)
    if not cfg.tie_embeddings:
        sch['lm_head'] = L.dense_schema(cfg.d_model, cfg.vocab_size)
    return sch


def _decoder_layers(bp: Dict):
    """Every decoder layer's parameters in order: layer 0, the stacked
    body's views, the tail."""
    yield bp['layer0']
    if 'body' in bp:
        body = bp['body'][0]
        for r in range(body['ln_x']['scale'].shape[0]):
            yield tree_slice(body, r)
    yield from bp.get('tail', [])


def _cross(p: Dict, h: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The cross-attention sublayer's residual: ln_x, the query
    projection, attention over the encoder's k/v (B, T, kv_size), wo."""
    q = L.dense(p['xattn']['wq'], L.norm_apply(p['ln_x'], h, cfg.norm))
    return h + L.dense(p['xattn']['wo'], A.cross_attention_core(q, k, v, cfg))


def _ffn(p: Dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return h + ffn_apply(p['ffn'], L.norm_apply(p['ln2'], h, cfg.norm),
                         act=cfg.act)


def _dec_layer_full(p: Dict, h: torch.Tensor, positions: torch.Tensor,
                    enc_out: torch.Tensor, cfg: ModelConfig,
                    pre: Optional[Dict] = None) -> torch.Tensor:
    """Self-attn (+pre rows) -> cross-attn -> FFN."""
    if pre is not None:
        attn = A.full_attention(p['attn'], None, positions, cfg,
                                rope_theta=cfg.rope_theta,
                                qkv=(pre['q'], pre['k'], pre['v']))
    else:
        attn = A.full_attention(p['attn'],
                                L.norm_apply(p['ln1'], h, cfg.norm),
                                positions, cfg, rope_theta=cfg.rope_theta)
    h = h + attn
    h = _cross(p, h, L.dense(p['xattn']['wk'], enc_out),
               L.dense(p['xattn']['wv'], enc_out), cfg)
    return _ffn(p, h, cfg)


@torch.no_grad()
def encdec_apply(params: Dict, tokens: torch.Tensor, frames: torch.Tensor,
                 cfg: ModelConfig, *, precomputed=None,
                 return_hidden: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B, S), frames (B, T, fd)) -> (logits (B, S, V), aux = 0).
    With ``precomputed`` layer 0's self-attention reads the table's
    ``[x, q, k, v]`` rows (the ``embed_gather`` kernel on the card)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    enc_out = encoder_apply(params['encoder'], frames, cfg)
    if precomputed is not None:
        pre0 = precomputed.gather(tokens)
        h = pre0['x']
    else:
        pre0 = None
        h = embed_tokens(params, tokens, cfg, positions)
    for i, p in enumerate(_decoder_layers(params['backbone'])):
        h = _dec_layer_full(p, h, positions, enc_out, cfg,
                            pre=pre0 if i == 0 else None)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h = L.norm_apply(params['final_norm'], h, cfg.norm)
    if return_hidden:
        return h, aux
    return lm_head(params, h, cfg), aux


# ------------------------------------------------------------------ decode
def encdec_make_states(cfg: ModelConfig, batch: int, seq_len: int,
                       dtype: torch.dtype = torch.bfloat16,
                       device: torch.device | str = 'cuda') -> Dict:
    """Self-attention KV caches (``seq_len`` entries) and zeroed cross K/V
    of (B, source_len, KV, hd) a layer (:func:`prefill_cross_cache` fills
    them; :func:`put_cross_cache` copies them in)."""
    plan = layer_plan(cfg)
    T = cfg.encoder.source_len
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def one() -> Dict[str, torch.Tensor]:
        st = A.make_cache(cfg, batch, seq_len, dtype=dtype, device=device)
        for nm in ('xk', 'xv'):
            st[nm] = torch.zeros((batch, T, KV, hd), dtype=dtype,
                                 device=device)
        return st

    st: Dict[str, Any] = {'layer0': one()}
    if plan.reps:
        st['body'] = [{nm: leaf[None].repeat((plan.reps,) + (1,) * leaf.dim())
                       for nm, leaf in one().items()}]
    if plan.n_tail:
        st['tail'] = [one() for _ in range(plan.n_tail)]
    return st


@torch.no_grad()
def prefill_cross_cache(params: Dict, enc_out: torch.Tensor,
                        cfg: ModelConfig) -> Dict:
    """Per-layer cross K/V from the encoder output (once per request):
    ``{'layer0': (k, v), 'body': [(k, v) stacked over the body's layers],
    'tail': [(k, v), ...]}``, each (B, T, KV, hd)."""
    B, T = enc_out.shape[:2]

    def xkv(p):
        return tuple(L.dense(p['xattn'][nm], enc_out).reshape(
            B, T, cfg.num_kv_heads, cfg.head_dim) for nm in ('wk', 'wv'))
    bp = params['backbone']
    out: Dict[str, Any] = {'layer0': xkv(bp['layer0'])}
    if 'body' in bp:
        body = bp['body'][0]
        per = [xkv(tree_slice(body, r))
               for r in range(body['ln_x']['scale'].shape[0])]
        out['body'] = [tuple(torch.stack(x) for x in zip(*per))]
    if 'tail' in bp:
        out['tail'] = [xkv(p) for p in bp['tail']]
    return out


def put_cross_cache(states: Dict, xkv: Dict) -> Dict:
    """Copy :func:`prefill_cross_cache`'s K/V into the states' ``xk`` /
    ``xv`` leaves, in place (their addresses stay: a captured CUDA graph of
    the decode step keeps reading them)."""
    pairs = [(states['layer0'], xkv['layer0'])]
    if 'body' in xkv:
        pairs.append((states['body'][0], xkv['body'][0]))
    pairs += list(zip(states.get('tail', []), xkv.get('tail', [])))
    for st, (k, v) in pairs:
        st['xk'].copy_(k)
        st['xv'].copy_(v)
    return states


def _dec_layer_step(p: Dict, h: torch.Tensor, st: Dict, pos: torch.Tensor,
                    cfg: ModelConfig, pre: Optional[Dict] = None
                    ) -> torch.Tensor:
    attn, _ = A.decode_step(
        p['attn'], None if pre is not None
        else L.norm_apply(p['ln1'], h, cfg.norm), st, pos, cfg,
        rope_theta=cfg.rope_theta,
        qkv=(pre['q'], pre['k'], pre['v']) if pre is not None else None,
        backend=REFERENCE)
    h = h + attn
    B = h.shape[0]
    h = _cross(p, h, st['xk'].reshape(B, -1, cfg.kv_size),
               st['xv'].reshape(B, -1, cfg.kv_size), cfg)
    return _ffn(p, h, cfg)


def _state_layers(states: Dict):
    """Every decoder layer's state in the order of :func:`_decoder_layers`
    (views of the stacked body leaves)."""
    yield states['layer0']
    if 'body' in states:
        body = states['body'][0]
        for r in range(body['pos'].shape[0]):
            yield tree_slice(body, r)
    yield from states.get('tail', [])


@torch.no_grad()
def encdec_decode_step(params: Dict, tokens: torch.Tensor, states: Dict,
                       pos: torch.Tensor, cfg: ModelConfig, *,
                       precomputed=None) -> Tuple[torch.Tensor, Dict]:
    """One decoder token a slot: tokens (B, 1) at positions pos (B,) ->
    (logits (B, 1, V), states), the self caches written in place."""
    if precomputed is not None:
        pre0 = precomputed.gather(tokens)
        h = pre0['x']
    else:
        pre0 = None
        h = embed_tokens(params, tokens, cfg, pos[:, None]
                         if cfg.pos == 'learned' else None)
    for i, (p, st) in enumerate(zip(_decoder_layers(params['backbone']),
                                    _state_layers(states))):
        h = _dec_layer_step(p, h, st, pos, cfg, pre=pre0 if i == 0 else None)
    return lm_logits(params, h, cfg), states
