"""Grouped-query attention with RoPE: the full-sequence cores of the forward
pass and the attend against dense (ring) KV caches and the paged KV pool —
the full-sequence, dense-cache, paged and packed-prefill parts of
``repro/models/attention.py``.

The full-sequence core (:func:`attention_core`) takes the naive O(S^2)
path below ``BLOCKED_THRESHOLD`` tokens and the blocked one
(``kernels.flash_attention``) from there on, as in JAX.

Caches are dicts ``{'k': (B, Sc, KV, hd), 'v': (B, Sc, KV, hd),
'pos': (B, Sc) int32}``; ``pos`` holds each entry's token position (-1 =
never written), which is all the attend needs to mask ring wraparound,
windows and unwritten rows. Sliding-window layers keep a ring of
``cache_len(window, seq, chunk)`` entries; position p lives at ``p % Sc``.

**int8 caches** (``quant=True``): K/V are int8 with a bf16 scale per
(token, kv head) in ``k_scale`` / ``v_scale`` (B, Sc, KV), made by
:func:`_quantize` at every write; the scale leaves are written wherever
K/V are. A ``fused_maintenance`` backend's paged write quantizes inside the
``fused_page_write`` launch instead, to the same bits. The attend folds ``k_scale`` into the scores and ``v_scale`` into
the probabilities (:func:`_attend_lanes`).

**Caches are updated in place.** JAX returns new cache arrays; PyTorch runs
eagerly, so :func:`cache_update` and :func:`cache_update_chunk` write the
new entries into the given tensors (which may be views into the stacked
per-layer state) and return the same dict. Contents — ``pos`` included,
ring wraparound and chunks that lap the ring included — equal JAX's
exactly.

**Paged mode** replaces the per-slot caches with a pool of
``(num_pages, page_size, ...)`` pages addressed through per-slot page
tables (:class:`PageTables`); chunk writes go through :func:`chunk_write`,
also in place.

How queries read the cache is the attention backend's decision
(``repro_torch.models.attn_backend``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_maintenance import quantize_rows
from repro_torch.models import layers as L

NEG_INF = -2.0 ** 30   # large-negative that survives bf16


def _backend(backend, device):
    from repro_torch.models.attn_backend import get_backend
    return get_backend(backend, device)


def attention_schema(cfg: ModelConfig) -> Dict:
    d, q, e = cfg.d_model, cfg.q_size, cfg.kv_size
    sch = {'wq': L.dense_schema(d, q), 'wk': L.dense_schema(d, e),
           'wv': L.dense_schema(d, e),
           'wo': L.dense_schema(cfg.attn_out_size, d)}
    if cfg.qk_norm:
        sch['q_norm'] = {'scale': L.ParamSpec((cfg.head_dim,), 'ones')}
        sch['k_norm'] = {'scale': L.ParamSpec((cfg.head_dim,), 'ones')}
    return sch


# ============================================== the part precompute removes
def compute_qkv(params: Dict, x_normed: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project LN(x) -> (q, k, v), flat head layout, PRE-RoPE — exactly the
    position-independent computation the paper moves into the table
    (``qk_norm`` included: :func:`qk_normalize`)."""
    q, k = qk_normalize(params, L.dense(params['wq'], x_normed),
                        L.dense(params['wk'], x_normed), cfg)
    return q, k, L.dense(params['wv'], x_normed)


def qk_normalize(params: Dict, q: torch.Tensor, k: torch.Tensor,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """gemma3's ``qk_norm``: an RMSNorm over each head of the flat q and k
    (``q_norm`` / ``k_norm`` scales of width head_dim), as in JAX's
    ``compute_qkv``; q and k unchanged without it. Position-independent,
    so the table folds it in."""
    if not cfg.qk_norm:
        return q, k
    lead, hd = q.shape[:-1], cfg.head_dim
    q = L.rmsnorm(q.reshape(*lead, cfg.num_heads, hd),
                  params['q_norm']['scale']).reshape(*lead, -1)
    k = L.rmsnorm(k.reshape(*lead, cfg.num_kv_heads, hd),
                  params['k_norm']['scale']).reshape(*lead, -1)
    return q, k


# ============================================================ full-seq core
BLOCKED_THRESHOLD = 2048     # use the blocked (flash) core for S >= this


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig, *,
                   rope_theta: float, window: int = 0,
                   causal: bool = True) -> torch.Tensor:
    """Dispatch: the naive core for short sequences, the blocked flash core
    for long causal ones."""
    if q.shape[1] >= BLOCKED_THRESHOLD and causal:
        return blocked_attention_core(q, k, v, positions, cfg,
                                      rope_theta=rope_theta, window=window)
    return naive_attention_core(q, k, v, positions, cfg,
                                rope_theta=rope_theta, window=window,
                                causal=causal)


def _heads_with_rope(q, k, v, positions, cfg: ModelConfig, rope_theta):
    """Flat (B, S, ·) q/k/v -> per-head (B, S, H|KV, hd), q and k rotated."""
    B, S = q.shape[0], q.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.pos == 'rope':
        q = L.apply_rope(q, positions, rope_theta)
        k = L.apply_rope(k, positions, rope_theta)
    return q, k, v


def naive_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, cfg: ModelConfig, *,
                         rope_theta: float, window: int = 0,
                         causal: bool = True) -> torch.Tensor:
    """RoPE + masked softmax attention over a full sequence, O(S^2) memory.

    q (B, S, q_size), k/v (B, S, e) flat; positions (B, S) -> (B, S,
    attn_out_size) flat. fp32 scores; the probabilities take v's dtype
    before the value mix, as in JAX."""
    B, S = q.shape[0], q.shape[1]
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    q, k, v = _heads_with_rope(q, k, v, positions, cfg, rope_theta)
    q = q.reshape(B, S, KV, cfg.num_heads // KV, hd)
    scores = torch.einsum('bqkgd,bskd->bkgqs', q.float(),
                          k.float()) * hd ** -0.5
    i = positions[:, None, None, :, None]          # query positions
    j = positions[:, None, None, None, :]          # key positions
    mask = torch.ones((B, 1, 1, S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window:
        mask &= (i - j) < window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum('bkgqs,bskd->bqkgd', probs, v)
    return ctx.reshape(B, S, cfg.num_heads * hd)


def blocked_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           positions: torch.Tensor, cfg: ModelConfig, *,
                           rope_theta: float, window: int = 0
                           ) -> torch.Tensor:
    """Flash-style blocked causal attention, O(S * tile) memory: RoPE as in
    :func:`naive_attention_core`, then ``kernels.flash_attention`` — the
    CUDA kernel on the card, its plain version on the CPU (JAX's blocked
    core is the jnp mirror of the same Pallas kernel). Output in v's
    dtype."""
    B, S = q.shape[0], q.shape[1]
    q, k, v = _heads_with_rope(q, k, v, positions, cfg, rope_theta)
    ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          positions.to(torch.int32).contiguous(),
                          causal=True, window=window)
    return ctx.reshape(B, S, cfg.num_heads * cfg.head_dim)


def full_attention(params: Dict, x_normed: Optional[torch.Tensor],
                   positions: torch.Tensor, cfg: ModelConfig, *,
                   rope_theta: float, window: int = 0,
                   qkv: Optional[Tuple] = None) -> torch.Tensor:
    """Full-sequence attention with the output projection (prefill).
    ``qkv`` supplies the (q, k, v) projections — precomputed rows, or the
    fused ``rmsnorm_qkv`` — instead of projecting ``x_normed``."""
    q, k, v = compute_qkv(params, x_normed, cfg) if qkv is None else qkv
    ctx = attention_core(q, k, v, positions, cfg, rope_theta=rope_theta,
                         window=window)
    return L.dense(params['wo'], ctx)


def cross_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    """Encoder-decoder cross attention: no mask, no RoPE on either side.
    q (B, S, q_size), k/v (B, Sk, kv_size) flat -> (B, S, H*hd); fp32
    scores, the probabilities in v's dtype before the value mix, as JAX."""
    B, S, Sk = q.shape[0], q.shape[1], k.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = q.reshape(B, S, KV, H // KV, hd)
    k = k.reshape(B, Sk, KV, hd)
    v = v.reshape(B, Sk, KV, hd)
    scores = torch.einsum('bqkgd,bskd->bkgqs', q.float(), k.float()) \
        * hd ** -0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum('bkgqs,bskd->bqkgd', probs, v)
    return ctx.reshape(B, S, H * hd)


# ================================================================== KV cache
def cache_len(window: int, seq_len: int, chunk: int = 1) -> int:
    """Ring length of a sliding-window cache; ``chunk - 1`` slack rows keep a
    late in-chunk write from evicting a key an early in-chunk query still
    needs."""
    if not window:
        return seq_len
    return min(window + max(0, chunk - 1), seq_len)


def _kv_leaves(lead: Tuple[int, ...], KV: int, hd: int, dtype: torch.dtype,
               quant: bool, device) -> Dict[str, torch.Tensor]:
    """K/V leaves (and, for int8, their bf16 scales) of leading shape
    ``lead``, plus the position leaf (-1 = never written)."""
    kv_dtype = torch.int8 if quant else dtype
    cache = {
        'k': torch.zeros(lead + (KV, hd), dtype=kv_dtype, device=device),
        'v': torch.zeros(lead + (KV, hd), dtype=kv_dtype, device=device),
        'pos': torch.full(lead, -1, dtype=torch.int32, device=device),
    }
    if quant:
        cache['k_scale'] = torch.zeros(lead + (KV,), dtype=torch.bfloat16,
                                       device=device)
        cache['v_scale'] = torch.zeros(lead + (KV,), dtype=torch.bfloat16,
                                       device=device)
    return cache


def make_cache(cfg: ModelConfig, batch: int, seq_len: int, *, window: int = 0,
               dtype: torch.dtype = torch.bfloat16, quant: bool = False,
               chunk: int = 1, device: torch.device | str = 'cuda'
               ) -> Dict[str, torch.Tensor]:
    """Dense (ring) KV cache. ``quant=True``: int8 entries plus bf16
    per-(token, head) scales."""
    Sc = cache_len(window, seq_len, chunk)
    return _kv_leaves((batch, Sc), cfg.num_kv_heads, cfg.head_dim, dtype,
                      quant, device)


# (..., hd) -> int8 values + bf16 scale per row, bitwise as JAX's
# ``_quantize``; the paged write's kernel quantizes in its own launch
_quantize = quantize_rows


def kv_values(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """The leaf values a K/V write stores: ``k_new``/``v_new`` as they
    are, or, for an int8 cache, quantized with their scales."""
    if 'k_scale' not in cache:
        return {'k': k_new, 'v': v_new}
    kq, ks = _quantize(k_new)
    vq, vs = _quantize(v_new)
    return {'k': kq, 'v': vq, 'k_scale': ks, 'v_scale': vs}


def cache_update(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> Dict:
    """Write one decode step (B, 1, KV, hd) at ring index ``pos % Sc``, in
    place (int8 caches: with the scales)."""
    Sc = cache['pos'].shape[1]
    idx = (pos.long() % Sc)
    bidx = torch.arange(cache['pos'].shape[0], device=idx.device)
    for nm, val in kv_values(cache, k_new[:, 0], v_new[:, 0]).items():
        cache[nm][bidx, idx] = val.to(cache[nm].dtype)
    cache['pos'][bidx, idx] = pos.to(torch.int32)
    return cache


def ring_chunk_lanes(Sc: int, pos0: torch.Tensor, n_valid: torch.Tensor,
                     T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane-side form of JAX's ``ring_chunk_index``: for each chunk lane
    (B, T), the lane whose value it writes and the ring slot it writes.

    Lane ``t < n_valid`` lands on ``(pos0 + t) % Sc``; when a chunk laps the
    ring, the last valid lane landing on a slot wins. Each lane is mapped to
    that winner (lanes ``t >= n_valid`` to the winner of the last valid
    lane), so every write to a slot carries the same value: the scatter is
    deterministic and equals the sequential per-token writes. Returns
    ``(src, slot)``; ``src`` is -1 for slots with ``n_valid == 0``, whose
    lanes must write back what the slot already holds.
    """
    pos0 = pos0.long()[:, None]
    nv = n_valid.long()[:, None]
    t = torch.arange(T, device=pos0.device)[None]
    tv = torch.minimum(t, nv - 1)                       # last valid lane
    src = tv + Sc * torch.div(nv - 1 - tv, Sc, rounding_mode='floor')
    src = torch.where(nv > 0, src, torch.full_like(src, -1))
    slot = (pos0 + tv.clamp(min=0)) % Sc
    return src, slot


def ring_chunk_write(cache: Dict, vals: Dict[str, torch.Tensor],
                     pos0: torch.Tensor, n_valid: torch.Tensor) -> Dict:
    """Write a whole chunk of every leaf in ``vals`` (B, T, ...) — K/V, or
    MLA's latents — at ring indices ``(pos0 + t) % Sc`` for ``t <
    n_valid``, in place, the position leaf included: one scatter per leaf
    instead of T (see :func:`ring_chunk_lanes`)."""
    B, T = next(iter(vals.values())).shape[:2]
    Sc = cache['pos'].shape[1]
    src, slot = ring_chunk_lanes(Sc, pos0, n_valid, T)
    bidx = torch.arange(B, device=slot.device)[:, None].expand(B, T)
    live = src >= 0
    lane = src.clamp(min=0)

    def write(name, new):
        leaf = cache[name]
        old = leaf[bidx, slot]
        val = torch.gather(new, 1, lane.view((B, T) + (1,) * (new.dim() - 2))
                           .expand_as(new)).to(leaf.dtype)
        m = live.view((B, T) + (1,) * (val.dim() - 2))
        leaf[bidx, slot] = torch.where(m, val, old)

    for name, new in vals.items():
        write(name, new)
    write('pos', (pos0.long()[:, None] + lane).to(torch.int32))
    return cache


def cache_update_chunk(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                       pos0: torch.Tensor, n_valid: torch.Tensor) -> Dict:
    """Write a whole chunk (B, T, KV, hd) at ring indices ``(pos0 + t) %
    Sc`` for ``t < n_valid``, in place (:func:`ring_chunk_write`; int8
    caches: quantized, with the scales)."""
    return ring_chunk_write(cache, kv_values(cache, k_new, v_new), pos0,
                            n_valid)


# ================================================================== paged KV
@dataclasses.dataclass
class PageTables:
    """Per-slot page tables for paged-KV serving.

    ``pt`` (B, P_lin) int32 maps linear position blocks of append-only
    (full-causal) layers: position ``p`` lives in physical page
    ``pt[b, p // page_size]``. ``rt`` (B, P_ring) maps the ring blocks of
    sliding-window layers (``sc_ring`` entries; 0 = no ring layers).
    Physical page 0 is the null page (zero K/V, pos == -1): unallocated
    entries point at it and are masked out by position validity.

    ``pending`` (K,) int32, optional: pages awaiting deferred
    clear-on-alloc. ``jobs`` / ``ring_jobs``: the step's ``(job list,
    chunk positions)`` pair of ``kernels.paged_maintenance`` for the linear
    and the ring table, which ``fused_maintenance`` backends need: every
    layer's fused chunk write applies the list of its table, pending clears
    included (each list carries them all: every layer clears them in its
    own pool). The engine builds them once per step on the host, only for
    the tables its layers use; :meth:`with_jobs` builds both on the tables'
    device. Without ``fused_maintenance`` the engine clears eagerly and no
    job field is read.
    """
    pt: torch.Tensor
    rt: torch.Tensor
    sc_ring: int
    pending: Optional[torch.Tensor] = None
    jobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    ring_jobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def table_for(self, window: int, page_size: int
                  ) -> Tuple[torch.Tensor, int]:
        """(table, virtual cache length) for a layer of the given window."""
        if window and self.sc_ring:
            return self.rt, self.sc_ring
        return self.pt, self.pt.shape[1] * page_size

    def jobs_for(self, window: int
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The job list of the table :meth:`table_for` gives that layer."""
        return self.ring_jobs if window and self.sc_ring else self.jobs

    def with_jobs(self, pos0: torch.Tensor, n_valid: torch.Tensor,
                  page_size: int, T: int) -> 'PageTables':
        """A copy carrying the job lists of a T-lane chunk step at ``pos0``
        with ``n_valid`` lanes per slot, over the linear table and (with
        ``sc_ring``) the ring table."""
        from repro_torch.kernels import paged_maintenance as PM
        pending = self.pending if self.pending is not None else \
            torch.zeros(0, dtype=torch.int32, device=self.pt.device)
        pos_t = PM.chunk_positions(pos0, T)

        def jobs(table, Sc):
            return PM.build_jobs(pos0, n_valid, table, Sc, page_size, T,
                                 pending), pos_t
        return dataclasses.replace(
            self, pending=pending,
            jobs=jobs(self.pt, self.pt.shape[1] * page_size),
            ring_jobs=jobs(self.rt, self.sc_ring) if self.sc_ring else None)


# ============================================================ packed prefill
@dataclasses.dataclass
class PackedLayout:
    """Segment-packed chunk layout (prepacking, arXiv 2404.09529): the
    serving engine bin-packs every active slot's chunk segment (its
    ``n_valid`` tokens) into a smaller ``(R, T)`` grid, ``R <= S``. Slot
    ``s``'s segment occupies row ``seg_row[s]``, columns ``seg_off[s] ..
    seg_off[s] + n_valid[s] - 1``. Token-wise compute (the gather, norms,
    FFN, residuals, the head) runs on the packed grid; each mixer runs on
    the slot-major ``(S, T)`` layout reached by :meth:`to_slots` and goes
    back by :meth:`to_lanes`. Both are exact index gathers, so every cache
    write and page scatter keeps its unpacked shapes and bits, and a slot's
    queries only ever meet its own cache.

    ``seg_row`` / ``seg_off``: (S,) int32, (0, 0) for inactive slots.
    ``lane_slot`` / ``lane_local``: (R, T) int32, the owning slot and the
    offset in its segment (0 on empty lanes). ``lane_pos``: (R, T) int32
    absolute position (0 on empty lanes). ``lane_valid``: (R, T) bool.
    The two flat gather indices are made once, when the layout is built.
    """
    seg_row: torch.Tensor
    seg_off: torch.Tensor
    lane_slot: torch.Tensor
    lane_local: torch.Tensor
    lane_pos: torch.Tensor
    lane_valid: torch.Tensor

    def __post_init__(self):
        R, T = self.lane_slot.shape
        t = torch.arange(T, device=self.seg_row.device)[None]
        cols = torch.clamp(self.seg_off.long()[:, None] + t, max=T - 1)
        self._slot_idx = self.seg_row.long()[:, None] * T + cols    # (S, T)
        self._lane_idx = self.lane_slot.long() * T \
            + self.lane_local.long()                                # (R, T)

    def to_slots(self, x: torch.Tensor) -> torch.Tensor:
        """Packed ``(R, T, ...)`` -> slot-major ``(S, T, ...)``: slot ``s``'s
        lane ``t`` reads packed lane ``(seg_row[s], seg_off[s] + t)``; lanes
        past a segment read clipped in-row garbage, as inert as the unpacked
        path's padding lanes."""
        R, T = self.lane_slot.shape
        return x.reshape((R * T,) + x.shape[2:])[self._slot_idx]

    def to_lanes(self, y: torch.Tensor) -> torch.Tensor:
        """Slot-major ``(S, T, ...)`` -> the packed grid: lane ``(r, t)``
        reads ``y[lane_slot[r, t], lane_local[r, t]]`` (garbage on empty
        lanes)."""
        S, T = y.shape[:2]
        return y.reshape((S * T,) + y.shape[2:])[self._lane_idx]


def make_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     dtype: torch.dtype = torch.bfloat16, quant: bool = False,
                     device: torch.device | str = 'cuda'
                     ) -> Dict[str, torch.Tensor]:
    """Pool-shaped KV storage: the leaves of :func:`make_cache` with
    leading axes (num_pages, page_size). Page 0 is the null page and must
    stay in this initial state."""
    return _kv_leaves((num_pages, page_size), cfg.num_kv_heads, cfg.head_dim,
                      dtype, quant, device)


def paged_view(cache: Dict, table: torch.Tensor, Sc: int
               ) -> Dict[str, torch.Tensor]:
    """Gather a slot-indexed virtual ``(B, Sc, ...)`` cache out of the pool,
    with the dense cache's length and entry order, so attending it issues
    the dense path's contractions. Unallocated blocks resolve to the null
    page."""
    B, P = table.shape
    tab = table.long()

    def g(leaf):
        v = leaf[tab]                                    # (B, P, ps, ...)
        v = v.reshape((B, P * leaf.shape[1]) + tuple(leaf.shape[2:]))
        return v[:, :Sc]

    return {nm: g(leaf) for nm, leaf in cache.items()}


def paged_scatter(cache: Dict, updates: Dict[str, torch.Tensor],
                  pos0: torch.Tensor, n_valid: torch.Tensor,
                  table: torch.Tensor, Sc: int) -> Dict:
    """Write a chunk's T lanes through a page table (ring-aware), in place.

    ``updates[name]`` is (B, T, ...) chunk values for pool leaf ``name``;
    lane ``t < n_valid[b]`` of slot ``b`` lands at virtual index
    ``(pos0[b] + t) % Sc`` -> physical row ``table[b, idx // ps] * ps +
    idx % ps``; other lanes are not written. Targets are unique (slots
    never share writable pages, a chunk cannot lap the ring), so the
    result equals the dense path's sequential writes. The 'pos' leaf is
    maintained here.
    """
    any_upd = next(iter(updates.values()))
    B, T = any_upd.shape[:2]
    NP, ps = cache['pos'].shape[:2]
    assert T <= Sc, 'chunk must not lap the paged ring'
    t = torch.arange(T, device=pos0.device)[None]
    pos_t = pos0.long()[:, None] + t                         # (B, T)
    idx = pos_t % Sc
    page = torch.gather(table.long(), 1, torch.div(idx, ps,
                                                   rounding_mode='floor'))
    flat = page * ps + idx % ps
    valid = t < n_valid.long()[:, None]
    rows = flat[valid]

    def scat(leaf, vals):
        fl = leaf.view((NP * ps,) + tuple(leaf.shape[2:]))
        fl[rows] = vals[valid].to(leaf.dtype)

    for nm, vals in updates.items():
        scat(cache[nm], vals)
    scat(cache['pos'], pos_t.to(torch.int32))
    return cache


def paged_write(cache: Dict, vals: Dict[str, torch.Tensor],
                pos0: torch.Tensor, n_valid: torch.Tensor, *, window: int,
                paged: PageTables, backend=None) -> Dict:
    """Chunk write of the leaves ``vals`` (B, T, ...) — K/V, or MLA's
    latents — into pool storage through the layer's page table, in place,
    the position leaf included. A ``fused_maintenance`` backend writes
    with the ``fused_page_write`` job list of the layer's table
    (``paged.jobs_for``), which also applies the step's deferred clears,
    and raises without it; otherwise
    :func:`paged_scatter`. Into an int8 cache ``vals`` carries the float
    ``k`` / ``v`` alone: the fused write quantizes them in its launch, the
    plain scatter through :func:`kv_values`."""
    table, Sc = paged.table_for(window, cache['pos'].shape[1])
    device = next(iter(vals.values())).device
    if getattr(_backend(backend, device), 'fused_maintenance', False):
        from repro_torch.kernels import paged_maintenance as PM
        jobs = paged.jobs_for(window)
        if jobs is None:
            raise ValueError(
                'fused paged writes need the step job list of the layer\'s '
                'page table: PageTables.jobs (linear) or ring_jobs (see '
                'PageTables.with_jobs)')
        return PM.fused_chunk_scatter(cache, vals, *jobs, Sc=Sc)
    if 'k_scale' in cache:
        vals = kv_values(cache, vals['k'], vals['v'])
    return paged_scatter(cache, vals, pos0, n_valid, table, Sc)


def chunk_write(cache: Dict, k_h: torch.Tensor, v_h: torch.Tensor,
                pos0: torch.Tensor, n_valid: torch.Tensor, *, window: int,
                paged: Optional[PageTables], backend=None) -> Dict:
    """Chunk K/V write into the stored cache, in place: the dense ring
    update, or :func:`paged_write` in paged mode (int8 caches: quantized,
    with the scales)."""
    if paged is None:
        return cache_update_chunk(cache, k_h, v_h, pos0, n_valid)
    return paged_write(cache, {'k': k_h, 'v': v_h}, pos0, n_valid,
                       window=window, paged=paged, backend=backend)


# ================================================================ decode core
def step_context(params: Dict, x_normed: Optional[torch.Tensor],
                 cache: Dict, pos: torch.Tensor, cfg: ModelConfig, *,
                 rope_theta: float, window: int = 0,
                 qkv: Optional[Tuple] = None, backend=None) -> torch.Tensor:
    """One-token attention up to the context, before any output
    projection: (qkv or projections) -> cache write -> attend. ``qkv``
    supplies precomputed (q, k, v) rows (the paper's layer-0 path)."""
    q, k, v = compute_qkv(params, x_normed, cfg) if qkv is None else qkv
    B = q.shape[0]
    k_h = k.reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    if cfg.pos == 'rope':
        k_h = L.apply_rope(k_h, pos[:, None], rope_theta)
    v_h = v.reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    cache_update(cache, k_h, v_h, pos)
    return _backend(backend, q.device).attend_chunk(
        q, cache, pos, cfg, rope_theta=rope_theta, window=window)


def decode_step(params: Dict, x_normed: Optional[torch.Tensor], cache: Dict,
                pos: torch.Tensor, cfg: ModelConfig, *, rope_theta: float,
                window: int = 0, qkv: Optional[Tuple] = None, backend=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token step: :func:`step_context`, then wo."""
    ctx = step_context(params, x_normed, cache, pos, cfg,
                       rope_theta=rope_theta, window=window, qkv=qkv,
                       backend=backend)
    return L.dense(params['wo'], ctx), cache


def _attend_lanes(q: torch.Tensor, cache: Dict, pos_t: torch.Tensor,
                  cfg: ModelConfig, window: int) -> torch.Tensor:
    """Masked softmax attention of (B, T', KV, G, hd) post-RoPE queries at
    positions ``pos_t`` (B, T') against the cache -> (B, T', KV, G, hd).
    int8 caches: the scores are multiplied by ``k_scale`` and then by
    ``hd**-0.5``; ``v_scale`` multiplies the probabilities after the
    softmax; the output takes q's dtype (as JAX)."""
    hd = cfg.head_dim
    quant = 'k_scale' in cache
    scores = torch.einsum('btkgd,bskd->bkgts', q.float(), cache['k'].float())
    if quant:
        scores = scores * cache['k_scale'].float() \
            .transpose(1, 2)[:, :, None, None, :]
    scores = scores * hd ** -0.5
    cp = cache['pos'][:, None, None, None, :]                # (B,1,1,1,Sc)
    qp = pos_t[:, None, None, :, None]                       # (B,1,1,T',1)
    valid = (cp >= 0) & (cp <= qp)
    if window:
        valid &= (qp - cp) < window
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    v = cache['v']
    if quant:
        pv = probs * cache['v_scale'].float() \
            .transpose(1, 2)[:, :, None, None, :]
        return torch.einsum('bkgts,bskd->btkgd', pv, v.float()).to(q.dtype)
    return torch.einsum('bkgts,bskd->btkgd', probs.to(v.dtype), v)


def decode_attend_chunk(q: torch.Tensor, cache: Dict, pos0: torch.Tensor,
                        cfg: ModelConfig, *, rope_theta: float,
                        window: int = 0,
                        rope_applied: bool = False) -> torch.Tensor:
    """T-query attention against the (already chunk-updated) cache, query
    lanes one at a time (the reference backend's attend).

    q: (B, T, q_size) flat; lane t sits at position ``pos0 + t``. In-chunk
    causality needs no extra mask: the chunk's own keys carry their
    positions. ``rope_applied`` skips the q rotation for rows from the
    fused gather→RoPE kernel.
    """
    B, T = q.shape[0], q.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = q.reshape(B, T, H, hd)
    pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
    if cfg.pos == 'rope' and not rope_applied:
        q = L.apply_rope(q, pos_t, rope_theta)
    q = q.reshape(B, T, KV, H // KV, hd)
    ctx = torch.cat([_attend_lanes(q[:, t:t + 1], cache, pos_t[:, t:t + 1],
                                   cfg, window) for t in range(T)], dim=1)
    return ctx.reshape(B, T, H * hd)


def chunk_context(params: Dict, x_normed: Optional[torch.Tensor],
                  cache: Dict, pos0: torch.Tensor, n_valid: torch.Tensor,
                  cfg: ModelConfig, *, rope_theta: float, window: int = 0,
                  qkv: Optional[Tuple] = None, rope_applied: bool = False,
                  paged: Optional[PageTables] = None,
                  backend=None) -> torch.Tensor:
    """Chunked-prefill attention up to the context, before any output
    projection: project (or take precomputed) a T-token chunk, write its
    valid prefix into the cache in one call, attend all T queries.
    ``rope_applied`` marks gathered rows already rotated by the fused
    kernel; ``paged`` switches the cache to page-pool addressing."""
    q, k, v = compute_qkv(params, x_normed, cfg) if qkv is None else qkv
    B, T = q.shape[0], q.shape[1]
    k_h = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    if cfg.pos == 'rope' and not rope_applied:
        pos_t = pos0[:, None].long() + torch.arange(T, device=q.device)
        k_h = L.apply_rope(k_h, pos_t, rope_theta)
    v_h = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    chunk_write(cache, k_h, v_h, pos0, n_valid, window=window, paged=paged,
                backend=backend)
    return _backend(backend, q.device).attend_chunk(
        q, cache, pos0, cfg, rope_theta=rope_theta, window=window,
        rope_applied=rope_applied, paged=paged)


def decode_chunk(params: Dict, x_normed: Optional[torch.Tensor], cache: Dict,
                 pos0: torch.Tensor, n_valid: torch.Tensor, cfg: ModelConfig,
                 *, rope_theta: float, window: int = 0,
                 qkv: Optional[Tuple] = None, rope_applied: bool = False,
                 paged: Optional[PageTables] = None,
                 backend=None) -> Tuple[torch.Tensor, Dict]:
    """Chunked-prefill step: :func:`chunk_context`, then wo."""
    ctx = chunk_context(params, x_normed, cache, pos0, n_valid, cfg,
                        rope_theta=rope_theta, window=window, qkv=qkv,
                        rope_applied=rope_applied, paged=paged,
                        backend=backend)
    return L.dense(params['wo'], ctx), cache
