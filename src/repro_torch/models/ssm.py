"""Recurrent blocks (port of ``repro/models/ssm.py``): xLSTM's mLSTM and
sLSTM, and the Mamba2-style heads of Hymba.

Each recurrence has a full-sequence form (``*_apply``: the position-wise
projections and gates over the whole sequence, then a plain Python loop
over time with as few ops a step as the recurrence allows; JAX's
``time_scan`` checkpoints its loop for the backward pass only, so the
forward needs none of it) and a decode form (``*_step``): the one-token
step, or a T-lane chunk with per-slot ``n_valid`` through
:func:`masked_chunk_scan`, which calls the one-token step's functions at
its shapes once per lane, so a chunk is bitwise ``n_valid`` single steps.
The recurrences are PyTorch ops, as JAX leaves them to XLA (no Pallas).

**State is written in place.** A step computes the new state leaves and
copies them into the tensors of ``state`` (which may be views into the
engine's stacked, bucketed state), so a captured CUDA graph keeps its
addresses; the returned dict is ``state`` itself.

Paper relevance: these blocks have no positional encoding, so their input
projections are functions of LN(embedding) alone and fold into the
precomputed table (:func:`mlstm_preproj`, :func:`slstm_preproj`,
:func:`mamba_preproj`); the causal convolutions and the recurrences mix
positions and stay at run time.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec


def _commit(state: Dict[str, torch.Tensor],
            new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy the new leaves into ``state``'s tensors, in place."""
    for nm, val in new.items():
        state[nm].copy_(val)
    return state


# ======================================================= masked chunk scan
def masked_chunk_scan(step_fn, state: Tuple, xs_bt: Tuple,
                      n_valid: torch.Tensor) -> Tuple[Tuple, torch.Tensor]:
    """Scan a recurrence over the T lanes of a chunk with per-slot masked
    commits. ``step_fn(state, *x_t) -> (new_state, y_t)`` is the one-token
    recurrence (state: a tuple of (B, ...) leaves; x_t: (B, ...) slices).
    Lane t of slot b is computed for every slot but committed only where
    ``t < n_valid[b]``, by a pure select, so padding lanes leave the state
    bitwise untouched. The loop is unrolled over the (small, static) T,
    as JAX's. -> (final state, ys (B, T, ...))."""
    T = xs_bt[0].shape[1]
    ys = []
    for t in range(T):
        new_state, y_t = step_fn(state, *(x[:, t] for x in xs_bt))
        keep = t < n_valid
        state = tuple(torch.where(keep.view((-1,) + (1,) * (n.dim() - 1)),
                                  n, o) for n, o in zip(new_state, state))
        ys.append(y_t)
    return state, torch.stack(ys, dim=1)


# ============================================================== causal conv
def conv_schema(width: int, kernel: int) -> Dict:
    return {'w': ParamSpec((kernel, width)),
            'b': ParamSpec((width,), 'zeros')}


def causal_conv(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C), left-padded."""
    k = params['w'].shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    w = params['w'].to(x.dtype)
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(k))
    return out + params['b'].to(x.dtype)


def conv_step(params: Dict, x_t: torch.Tensor, buf: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t (B, C); buf (B, k-1, C) the previous inputs.
    -> (output (B, C), the new buffer)."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)           # (B, k, C)
    out = torch.einsum('bkc,kc->bc', window, params['w'].to(x_t.dtype))
    out = out + params['b'].to(x_t.dtype)
    return out, window[:, 1:, :]


# ==================================================================== mLSTM
def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    ed = cfg.ssm.expand * cfg.d_model
    H = cfg.ssm.num_ssm_heads
    return ed, H, ed // H


def mlstm_schema(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    ed, H, _ = mlstm_dims(cfg)
    return {
        'w_up': L.dense_schema(d, 2 * ed),
        'conv': conv_schema(ed, cfg.ssm.conv_kernel),
        'wq': L.dense_schema(ed, ed),
        'wk': L.dense_schema(ed, ed),
        'wv': L.dense_schema(ed, ed),
        'w_if': L.dense_schema(ed, 2 * H),
        'out_norm': {'scale': ParamSpec((ed,), 'ones')},
        'w_down': L.dense_schema(ed, d),
    }


def mlstm_preproj(params: Dict, xn: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Position-independent projections (the precomputable set): the
    up-projection's halves u1 / u2, the values and the i/f gate inputs."""
    u = L.dense(params['w_up'], xn)
    ed = u.shape[-1] // 2
    u1, u2 = u[..., :ed], u[..., ed:]
    return {'u1': u1, 'u2': u2, 'v': L.dense(params['wv'], u1),
            'ifg': L.dense(params['w_if'], u1)}


def _mlstm_recurrence(q, k, v, i_pre, f_pre, state):
    """One timestep. q, k, v (B, H, dh); i/f_pre (B, H); state (C, n, m)."""
    C, n, m = state
    f_log = F.logsigmoid(f_pre)                             # stabilised forget
    m_new = torch.maximum(f_log + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_log + m - m_new)
    C = f_g[..., None, None] * C + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])                  # (B, H, dk, dv)
    n = f_g[..., None] * n + i_g[..., None] * k
    num = torch.einsum('bhkv,bhk->bhv', C, q)
    den = torch.clamp(torch.abs(torch.einsum('bhk,bhk->bh', n, q)), min=1.0)
    h = num / den[..., None]
    return (C, n, m_new), h


def mlstm_init_state(cfg: ModelConfig, batch: int,
                     device: torch.device | str = 'cuda') -> Dict:
    ed, H, dh = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {'C': torch.zeros((batch, H, dh, dh), **f32),
            'n': torch.zeros((batch, H, dh), **f32),
            'm': torch.zeros((batch, H), **f32),
            'conv': torch.zeros((batch, cfg.ssm.conv_kernel - 1, ed), **f32)}


def _mlstm_qk(params: Dict, c_t: torch.Tensor, H: int, dh: int):
    """q and the scaled k of conv outputs c_t (B, S, ed), per head in
    fp32."""
    B, S = c_t.shape[:2]
    q = L.dense(params['wq'], c_t).reshape(B, S, H, dh).float()
    k = L.dense(params['wk'], c_t).reshape(B, S, H, dh).float() * dh ** -0.5
    return q, k


def _mlstm_core(params: Dict, pre: Dict, state: Dict, cfg: ModelConfig,
                n_valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """The one-token step (``n_valid`` None) or the masked chunk; writes
    the state in place."""
    ed, H, dh = mlstm_dims(cfg)
    dtype = pre['u1'].dtype
    B, S = pre['u1'].shape[:2]
    v_all = pre['v'].reshape(B, S, H, dh).float()
    ifg = pre['ifg'].float().reshape(B, S, 2, H)

    def one(carry, u1_t, v_t, i_t, f_t):
        C, n, m, buf = carry
        c_t, new_buf = conv_step(params['conv'], u1_t, buf.to(dtype))
        q_t, k_t = _mlstm_qk(params, F.silu(c_t)[:, None], H, dh)
        (C, n, m), h_t = _mlstm_recurrence(q_t[:, 0], k_t[:, 0], v_t, i_t,
                                           f_t, (C, n, m))
        return (C, n, m, new_buf.float()), h_t

    s0 = (state['C'], state['n'], state['m'], state['conv'])
    xs = (pre['u1'], v_all, ifg[:, :, 0], ifg[:, :, 1])
    if n_valid is None:
        s1, h = one(s0, *(x[:, 0] for x in xs))
        h = h[:, None]
    else:
        s1, h = masked_chunk_scan(one, s0, xs, n_valid)
    y = _mlstm_tail(params, pre, h.reshape(B, S, ed).to(dtype), cfg)
    return y, _commit(state, dict(zip(('C', 'n', 'm', 'conv'), s1)))


def _mlstm_tail(params: Dict, pre: Dict, h: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Token-wise output path: head-norm, gate, down-projection."""
    ed, H, dh = mlstm_dims(cfg)
    B, S = h.shape[:2]
    h = L.rmsnorm(h.reshape(B, S, H, dh),
                  params['out_norm']['scale'].reshape(H, dh)).reshape(B, S, ed)
    return L.dense(params['w_down'], h * F.silu(pre['u2']))


def mlstm_apply(params: Dict, xn: Optional[torch.Tensor], cfg: ModelConfig,
                *, pre: Optional[Dict] = None) -> torch.Tensor:
    """Full-sequence mLSTM on pre-normed input (or its precomputed
    projections ``pre``), from the zero state."""
    if pre is None:
        pre = mlstm_preproj(params, xn)
    ed, H, dh = mlstm_dims(cfg)
    dtype = pre['u1'].dtype
    B, S = pre['u1'].shape[:2]
    q, k = _mlstm_qk(params, F.silu(causal_conv(params['conv'], pre['u1'])),
                     H, dh)
    v = pre['v'].reshape(B, S, H, dh).float()
    ifg = pre['ifg'].float().reshape(B, S, 2, H)
    i_pre, f_log = ifg[:, :, 0], F.logsigmoid(ifg[:, :, 1])
    st = mlstm_init_state(cfg, B, pre['u1'].device)
    # the stabiliser m is a scan of its own over (B, H) scalars; with it
    # the gates of every step are position-wise (the one-token step's
    # arithmetic, in another order: the same values up to rounding)
    m, ms = st['m'], []
    for t in range(S):
        m = torch.maximum(f_log[:, t] + m, i_pre[:, t])
        ms.append(m)
    m_all = torch.stack(ms, dim=1)                          # (B, S, H)
    m_prev = torch.cat([st['m'][:, None], m_all[:, :-1]], dim=1)
    f_g = torch.exp(f_log + m_prev - m_all)
    ik = torch.exp(i_pre - m_all)[..., None] * k            # (B, S, H, dk)
    C, n, nums, dens = st['C'], st['n'], [], []
    for t in range(S):
        C = torch.addcmul(ik[:, t, :, :, None] * v[:, t, :, None, :],
                          f_g[:, t, :, None, None], C)
        n = torch.addcmul(ik[:, t], f_g[:, t, :, None], n)
        nums.append(torch.einsum('bhkv,bhk->bhv', C, q[:, t]))
        dens.append(torch.einsum('bhk,bhk->bh', n, q[:, t]))
    den = torch.clamp(torch.abs(torch.stack(dens, dim=1)), min=1.0)
    h = torch.stack(nums, dim=1) / den[..., None]
    return _mlstm_tail(params, pre, h.reshape(B, S, ed).to(dtype), cfg)


def mlstm_step(params: Dict, xn: Optional[torch.Tensor], state: Dict,
               cfg: ModelConfig, *, pre: Optional[Dict] = None,
               n_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """Decode step: T == 1, or a (B, T) chunk when ``n_valid`` is given."""
    if pre is None:
        pre = mlstm_preproj(params, xn)
    return _mlstm_core(params, pre, state, cfg, n_valid)


# ==================================================================== sLSTM
def slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    H = cfg.ssm.num_ssm_heads
    return H, cfg.d_model // H


def slstm_schema(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    H, dh = slstm_dims(cfg)
    pf = int(cfg.ssm.proj_factor_slstm * d)
    sch = {'conv': conv_schema(d, cfg.ssm.conv_kernel)}
    sch.update({nm: L.dense_schema(d, d)
                for nm in ('w_z', 'w_o', 'w_i', 'w_f')})
    sch.update({nm: ParamSpec((H, dh, dh))
                for nm in ('r_z', 'r_o', 'r_i', 'r_f')})
    sch.update({'out_norm': {'scale': ParamSpec((d,), 'ones')},
                'ffn_up': L.dense_schema(d, 2 * pf),
                'ffn_down': L.dense_schema(pf, d)})
    return sch


def slstm_preproj(params: Dict, xn: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The z/o gate inputs are precomputable; i/f need the conv output."""
    return {'z_in': L.dense(params['w_z'], xn),
            'o_in': L.dense(params['w_o'], xn), 'xn': xn}


def slstm_init_state(cfg: ModelConfig, batch: int,
                     device: torch.device | str = 'cuda') -> Dict:
    H, dh = slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {'h': torch.zeros((batch, H, dh), **f32),
            'c': torch.zeros((batch, H, dh), **f32),
            'n': torch.ones((batch, H, dh), **f32),
            'm': torch.zeros((batch, H, dh), **f32),
            'conv': torch.zeros((batch, cfg.ssm.conv_kernel - 1,
                                 cfg.d_model), **f32)}


def _slstm_recurrent_weights(params: Dict) -> torch.Tensor:
    """r_z, r_o, r_i, r_f stacked in fp32: (4, H, dh, dh)."""
    return torch.stack([params[nm].float()
                        for nm in ('r_z', 'r_o', 'r_i', 'r_f')])


def _slstm_recurrence(R, x4, state):
    """One timestep. x4 (B, 4, H, dh): the z, o, i and f gate inputs;
    R (4, H, dh, dh): the fp32 recurrent weights, whose contributions of h
    come from one einsum; state (h, c, n, m)."""
    h, c, n, m = state
    pre = x4 + torch.einsum('ghij,bhj->bghi', R, h)
    z = torch.tanh(pre[:, 0])
    o = torch.sigmoid(pre[:, 1])
    i_raw = pre[:, 2]
    f_log = F.logsigmoid(pre[:, 3])
    m_new = torch.maximum(f_log + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_log + m - m_new)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new), h_new


def _slstm_if(params: Dict, c_t: torch.Tensor, H: int, dh: int):
    """i and f gate inputs of conv outputs c_t (B, S, d), per head in
    fp32."""
    B, S = c_t.shape[:2]
    return (L.dense(params['w_i'], c_t).reshape(B, S, H, dh).float(),
            L.dense(params['w_f'], c_t).reshape(B, S, H, dh).float())


def _slstm_core(params: Dict, pre: Dict, state: Dict, cfg: ModelConfig,
                n_valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """The one-token step (``n_valid`` None) or the masked chunk; writes
    the state in place."""
    H, dh = slstm_dims(cfg)
    xn = pre['xn']
    dtype = xn.dtype
    B, S = xn.shape[:2]
    R = _slstm_recurrent_weights(params)
    z_all = pre['z_in'].reshape(B, S, H, dh).float()
    o_all = pre['o_in'].reshape(B, S, H, dh).float()

    def one(carry, xn_t, z_t, o_t):
        h0, c0, n0, m0, buf = carry
        c_t, new_buf = conv_step(params['conv'], xn_t, buf.to(dtype))
        i_t, f_t = _slstm_if(params, F.silu(c_t)[:, None], H, dh)
        x4 = torch.stack([z_t, o_t, i_t[:, 0], f_t[:, 0]], dim=1)
        s_new, h_t = _slstm_recurrence(R, x4, (h0, c0, n0, m0))
        return s_new + (new_buf.float(),), h_t

    s0 = (state['h'], state['c'], state['n'], state['m'], state['conv'])
    xs = (xn, z_all, o_all)
    if n_valid is None:
        s1, h = one(s0, *(x[:, 0] for x in xs))
        h = h[:, None]
    else:
        s1, h = masked_chunk_scan(one, s0, xs, n_valid)
    y = _slstm_tail(params, h.reshape(B, S, cfg.d_model).to(dtype))
    return y, _commit(state, dict(zip(('h', 'c', 'n', 'm', 'conv'), s1)))


def _slstm_tail(params: Dict, h: torch.Tensor) -> torch.Tensor:
    """Token-wise output path: norm and the GeGLU FFN."""
    h = L.rmsnorm(h, params['out_norm']['scale'])
    up = L.dense(params['ffn_up'], h)
    pf = up.shape[-1] // 2
    gelu = L.activation('gelu')
    return L.dense(params['ffn_down'], gelu(up[..., :pf]) * up[..., pf:])


def slstm_apply(params: Dict, xn: Optional[torch.Tensor], cfg: ModelConfig,
                *, pre: Optional[Dict] = None) -> torch.Tensor:
    """Full-sequence sLSTM from the initial state (``pre`` carries the
    precomputed z/o inputs and the normed input ``xn``)."""
    if pre is None:
        pre = slstm_preproj(params, xn)
    H, dh = slstm_dims(cfg)
    xn = pre['xn']
    B, S = xn.shape[:2]
    i_in, f_in = _slstm_if(params, F.silu(causal_conv(params['conv'], xn)),
                           H, dh)
    z_in = pre['z_in'].reshape(B, S, H, dh).float()
    o_in = pre['o_in'].reshape(B, S, H, dh).float()
    x4 = torch.stack([z_in, o_in, i_in, f_in], dim=2)      # (B, S, 4, H, dh)
    R = _slstm_recurrent_weights(params)
    st = slstm_init_state(cfg, B, xn.device)
    s = (st['h'], st['c'], st['n'], st['m'])
    hs = []
    for t in range(S):
        s, h_t = _slstm_recurrence(R, x4[:, t], s)
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(B, S, cfg.d_model).to(xn.dtype)
    return _slstm_tail(params, h)


def slstm_step(params: Dict, xn: Optional[torch.Tensor], state: Dict,
               cfg: ModelConfig, *, pre: Optional[Dict] = None,
               n_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """Decode step: T == 1, or a (B, T) chunk when ``n_valid`` is given."""
    if pre is None:
        pre = slstm_preproj(params, xn)
    return _slstm_core(params, pre, state, cfg, n_valid)


# ============================================== Mamba2-style head (Hymba)
def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """Hymba keeps the SSM branch as wide as the attention branch."""
    ed = cfg.num_heads * cfg.head_dim
    H = cfg.ssm.num_ssm_heads
    return ed, H, ed // H


def mamba_schema(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    ed, H, _ = mamba_dims(cfg)
    N = cfg.ssm.state_dim
    return {
        'w_in': L.dense_schema(d, ed),
        'w_gate': L.dense_schema(d, ed),
        'conv': conv_schema(ed, cfg.ssm.conv_kernel),
        'w_bcdt': L.dense_schema(ed, 2 * N + H),
        'a_log': ParamSpec((H,), 'zeros'),
        'dt_bias': ParamSpec((H,), 'zeros'),
        'd_skip': ParamSpec((H,), 'ones'),
    }


def mamba_preproj(params: Dict, xn: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {'x_in': L.dense(params['w_in'], xn),
            'gate': L.dense(params['w_gate'], xn)}


def mamba_init_state(cfg: ModelConfig, batch: int,
                     device: torch.device | str = 'cuda') -> Dict:
    ed, _, _ = mamba_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {'S': torch.zeros((batch, ed, cfg.ssm.state_dim), **f32),
            'conv': torch.zeros((batch, cfg.ssm.conv_kernel - 1, ed), **f32)}


def _mamba_recurrence(x_c, B_, C_, dt_c, decay_c, d_skip_c, S):
    """Channel-flat selective-scan step: x_c (B, C), B_ / C_ (B, N), dt_c /
    decay_c (B, C) (per head, repeated over its channels), d_skip_c (C,),
    S (B, C, N) -> (S', y (B, C))."""
    S = decay_c[..., None] * S + (dt_c * x_c)[..., None] * B_[:, None, :]
    y = torch.einsum('bcn,bn->bc', S, C_) + d_skip_c[None, :] * x_c
    return S, y


def _mamba_consts(params: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt_bias and a = -exp(a_log) (negative), (H,) each in fp32: made once
    a call, outside the loops."""
    return params['dt_bias'].float(), -torch.exp(params['a_log'].float())


def _mamba_gates(params: Dict, xc: torch.Tensor, N: int, consts):
    """B, C, dt and the decay of conv outputs xc (..., ed), in fp32;
    ``consts`` from :func:`_mamba_consts`."""
    dt_bias, a = consts
    bcdt = L.dense(params['w_bcdt'], xc).float()
    dt = F.softplus(bcdt[..., 2 * N:] + dt_bias)
    return bcdt[..., :N], bcdt[..., N:2 * N], dt, torch.exp(a * dt)


def _mamba_core(params: Dict, pre: Dict, state: Dict, cfg: ModelConfig,
                n_valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """The one-token step (``n_valid`` None) or the masked chunk; writes
    the state in place."""
    ed, H, dh = mamba_dims(cfg)
    N = cfg.ssm.state_dim
    dtype = pre['x_in'].dtype
    B, S_len = pre['x_in'].shape[:2]
    dsk = torch.repeat_interleave(params['d_skip'].float(), dh)
    consts = _mamba_consts(params)

    def one(carry, x_t):
        S, buf = carry
        xc, new_buf = conv_step(params['conv'], x_t, buf.to(dtype))
        xc = F.silu(xc)[:, None]                             # (B, 1, ed)
        B_t, C_t, dt_t, decay_t = _mamba_gates(params, xc, N, consts)
        S, y_t = _mamba_recurrence(
            xc[:, 0].float(), B_t[:, 0], C_t[:, 0],
            torch.repeat_interleave(dt_t[:, 0], dh, dim=-1),
            torch.repeat_interleave(decay_t[:, 0], dh, dim=-1), dsk, S)
        return (S, new_buf.float()), y_t

    s0 = (state['S'], state['conv'])
    if n_valid is None:
        s1, y = one(s0, pre['x_in'][:, 0])
        y = y[:, None]
    else:
        s1, y = masked_chunk_scan(one, s0, (pre['x_in'],), n_valid)
    y = y.reshape(B, S_len, ed).to(dtype) * F.silu(pre['gate'])
    return y, _commit(state, dict(zip(('S', 'conv'), s1)))


def mamba_apply(params: Dict, xn: Optional[torch.Tensor], cfg: ModelConfig,
                *, pre: Optional[Dict] = None) -> torch.Tensor:
    """Full-sequence mamba heads from the zero state."""
    if pre is None:
        pre = mamba_preproj(params, xn)
    ed, H, dh = mamba_dims(cfg)
    N = cfg.ssm.state_dim
    dtype = pre['x_in'].dtype
    B, S_len = pre['x_in'].shape[:2]
    xc = F.silu(causal_conv(params['conv'], pre['x_in']))
    B_, C_, dt, decay = _mamba_gates(params, xc, N, _mamba_consts(params))
    # per-head dt / decay repeated over their channels once, not per step
    dt_c = torch.repeat_interleave(dt, dh, dim=-1)
    decay_c = torch.repeat_interleave(decay, dh, dim=-1)
    xf = xc.float()
    dsk = torch.repeat_interleave(params['d_skip'].float(), dh)
    # the step's input term (dt x) B of every step at once; then one op a
    # step, S_t = u_t + decay_t S_{t-1}, into the history of states, whose
    # read-out against C is one einsum (the one-token step's arithmetic in
    # another order: the same values up to rounding)
    u = (dt_c * xf)[..., None] * B_[:, :, None, :]         # (B, S, ed, N)
    S = mamba_init_state(cfg, B, xc.device)['S']
    hist = torch.empty((S_len,) + tuple(S.shape), dtype=S.dtype,
                       device=S.device)
    for t in range(S_len):
        S = torch.addcmul(u[:, t], decay_c[:, t, :, None], S, out=hist[t])
    y = torch.einsum('tbcn,btn->btc', hist, C_) + dsk * xf
    return y.to(dtype) * F.silu(pre['gate'])


def mamba_step(params: Dict, xn: Optional[torch.Tensor], state: Dict,
               cfg: ModelConfig, *, pre: Optional[Dict] = None,
               n_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """Decode step: T == 1, or a (B, T) chunk when ``n_valid`` is given."""
    if pre is None:
        pre = mamba_preproj(params, xn)
    return _mamba_core(params, pre, state, cfg, n_valid)
