"""Batched serving engine: continuous batching with chunked prefill over
dense per-slot KV caches or a paged KV pool with a radix prefix cache —
the port of ``repro/serving/engine.py``'s ``ServingEngine``.

The engine schedules **mixed steps** over a fixed set of slots. Decoding
slots consume one sampled token per step; prefilling slots consume up to
``chunk_size`` prompt tokens at once through the chunked decode path
(``Model.decode_step`` with ``n_valid``), which writes a whole chunk of
K/V per layer in one call. When every occupied slot is decoding, the step
narrows to the one-token path. In a chunk step the head runs only on each
slot's last valid lane. Finished slots are freed and refilled from the
queue; reuse resets the slot's cache rows in place.

THE PAPER lives here: with ``precomputed=`` every step's embedding read and
layer-0 projections are one row gather per token (the ``embed_gather``
kernel on a CUDA device); ``fused_gather_rope=True`` also folds layer-0
RoPE into the gather of chunked steps (the ``gather_rope`` kernel).

**Paged KV + prefix caching** (``prefix_cache=True``; attention layers,
GQA or MLA, ``'global'`` or windowed ``'local'``): the per-slot caches
(K/V, or MLA's latent ``ckv``/``kpe``) become a
global pool of ``page_size``-token pages per layer, addressed through
per-slot page tables, and admission looks the prompt up in a token-prefix
radix index (``repro_torch.serving.kvpool``). A request whose prompt
shares a cached prefix attaches its pages read-only and skips that part of
its prefill; one that stops short inside a cached page copies that page's
head rows into a private page (copy-on-write). Prefilled prompts publish
their full pages. Paged mode always runs the chunk-shaped step; its
T = 1 case is the decode step. When the pool runs dry and nothing is
evictable, a victim slot is **preempted** — fewest decoded tokens, LIFO
on ties, the oldest in-flight request protected — its full pages are
published to the radix index, and it is requeued at the front, so its
resume is a prefix hit and its greedy tokens equal an uninterrupted
run's. A request that cannot be scheduled even then fails with
``'unschedulable'``. With a ``fused_maintenance`` backend (``cuda``) page
writes are one ``fused_page_write`` launch per layer whose job list (one
for the linear table and one for the ring table, each built once per step
on the host and shared by the layers of that table) also clears freshly
allocated pages, and copy-on-write is ``cow_page_copy``; the reference
backend clears pages when they are allocated and writes with plain
scatters. Recurrent and conv state (xLSTM, a hybrid layer's mamba heads)
stays per slot beside the pool, never pooled: it is reset per slot and
rides in the snapshots below. A stack without attention (xlstm-125m) has
no page leaves at all: its page tables only key the radix index, and no
page kernel runs. Meta tokens (Hymba) are refused with JAX's
``ValueError``: the primed prefix would need template pages.

**Ring pages with snapshots** (configurations with windowed layers):
each slot also owns ``ceil(sc_ring / page_size)`` private ring pages,
addressed through a second table ``_rt``, where its windowed layers keep
the dense engine's ring of ``sc_ring = attention.cache_len(window,
max_seq, chunk)`` positions. Ring contents are rewritten during decode,
so they are never shared as pages: a prompt publishes at the last page
boundary before its final token (``((P - 1) // page_size) * page_size``;
its prefill stops exactly there) and hangs a **snapshot** on that radix
node — a copy of its ring pages on every layer (and of any per-slot state
rows). A later hit matches only nodes that carry one, and its admission
copies the snapshot into the new request's ring pages (copy-on-attach);
such configurations never copy on write. A preempted slot publishes only
when it stands at a page boundary. Recurrent stacks take snapshots too:
every layer's state is rewritten in place.

**MoE** layers route only real tokens: chunk padding and, in the dense
one-token step, free slots (``lane_valid``) are masked out of the expert
dispatch. Token slots dropped for expert capacity are counted in
``stats()['moe_token_drops']``.

**Attention backend** (``attn_backend='auto' | 'reference' | 'cuda'``):
``'auto'`` (the default) takes the ``cuda`` kernel backend on a CUDA
device and the plain ``reference`` backend on the CPU
(``repro_torch.models.attn_backend``). Greedy tokens of the two agree
wherever logits are not within the kernel tolerance of a tie; pool
contents written by the two are bitwise equal.

**Families.** A slot's reset copies its rows from a template made with
the states (JAX's ``_fresh``): empty caches, recurrent state as
``models.ssm`` initialises it (sLSTM's ``n`` is ones) and, for Hymba, the
state after its meta tokens, which ``transformer.prime_meta_states`` runs
through every slot once at construction (eagerly, on the engine's
attention backend); a slot's positions then start at
``num_meta_tokens``, and a prompt must leave room for them in
``max_seq``. A VLM serves text only, as the plain LM it decodes as. An
audio (enc-dec) model serves as JAX's engine does: chunk size 1, dense
caches (``prefix_cache=True`` raises ``ValueError``), no packing, the
``reference`` backend (``'auto'`` resolves to it on every device,
``'cuda'`` raises ``ValueError``), and every slot's cross K/V zero (the
engine runs no encoder).

**Requests** follow ``QUEUED -> PREFILLING -> DECODING -> FINISHED``
(``PREEMPTED`` while requeued after a preemption; ``Request.terminal`` is
true once ``FINISHED``, ``FAILED`` or ``CANCELLED``). Malformed submissions
(empty prompt, prompt that cannot fit ``max_seq``, ``max_new_tokens <=
0``) are ``FAILED`` at submit with ``error`` set; duplicate live uids raise
``ValueError``; ``deadline_s`` is enforced at every step on the monotonic
clock; ``cancel(uid)`` ends a request wherever it is (queued, mid-prefill,
mid-decode; dense, paged or on ring pages) as ``CANCELLED``, touching only
host structures (its slot and pages are freed); a lane whose sampled
logits are not finite fails only its request (``'nonfinite_logits'``);
``run()`` marks work still queued when its budget expires
``FAILED('stalled')``. ``run()`` and ``stats()`` count ``failed``,
``cancelled``, ``deadline_exceeded``, ``stalled`` and ``preemptions``.
``score()`` returns all-position prompt logits (logits on demand); scoring
requests always prefill cold.

**Fault injection** (``fault_injector=``, a
``repro_torch.serving.faults.FaultInjector`` such as ``ScriptedFaults``):
``before_step(engine)`` runs at the very top of every ``step_once``, before
the deadline sweep (page steals and restores, cancels, keyed on
``engine.ticks``); ``poison_lanes(engine, step_idx)`` names slots whose
finiteness flags the watchdog reads as false for the dispatch of engine
step ``step_idx`` (the value of ``engine.steps`` when it was dispatched,
the index the JAX engine gives the same dispatch, so one script poisons
the same lane in both engines).

**Telemetry** (``telemetry=False | True | a Telemetry``, through
``telemetry.coerce``; ``metrics()`` returns the registry's snapshot). Each
dispatching tick is split into five host-side phases, observed into the
``engine.step.phase_s`` histograms keyed by ``phase`` x ``backend``
(``reference`` / ``cuda``) x ``kind`` (``prefill`` / ``decode`` /
``mixed``: some lanes consume prompt tokens while others decode):

- ``host_schedule``: fault hooks, the deadline sweep, admission, lane
  building and preemption, with the radix time subtracted;
- ``radix_lookup``: time inside ``PrefixCache.match`` during this tick's
  admissions (a tick that admits but dispatches nothing drops it);
- ``pack_layout``: the bucket's temperatures, positions, tokens, page
  tables and job lists (``_step_arrays``, ``_paged_host``) staged into the
  step program's static input buffer (one host-to-device copy);
- ``dispatch``: the program's run: a CUDA graph's replay, or on a key's
  first step its eager run and its capture (as JAX's first call of a shape
  compiles inside its dispatch), or the eager forward. Under a mesh it
  also holds the tick's gather (``_rep_in``) before the body and split
  (``_shard_out``) after it, which the JAX engine runs inside its jitted
  step (a scoring run gathers once for all its ticks: that gather is
  charged to no phase);
- ``sample_commit``: ``_commit``, whose ``.cpu()`` of the sampled tokens
  is where the host waits for the device (in the async loop, the event of
  the step's output copies; observed one tick later).

The async loop also observes ``engine.step.overlap_s``: the host seconds
of a tick's first three phases spent while the previous dispatch was
still uncommitted.

Telemetry adds no device synchronisation: no ``.cpu()``, ``.item()`` or
``torch.cuda.synchronize()``, only host clock reads. PyTorch launches
kernels asynchronously, so on a CUDA device ``dispatch`` is the host's
cost of enqueueing the forward's kernels (or its graph), not their device
time, and the device's time lands in ``sample_commit``. Enabled engines
also register ``engine.queue.depth`` (a callback gauge),
``request.latency_s`` / ``request.ttft_s`` (observed at termination), the
``cow_copies`` counter and the pool's gauges
(``PrefixCache.bind_telemetry``), and record per-uid spans (SUBMIT, ADMIT
/ RESUME with ``prefix_hit_tokens``, PREFILL_CHUNK per dispatch,
FIRST_TOKEN, DECODE_STEP, PREEMPT, COW, FINISH / FAIL / CANCEL) and
engine-global events (EVICT, the ``FAULT_*`` injections) at the JAX
engine's sites. Disabled telemetry costs nothing: every site is guarded by
the one ``enabled`` bool of the shared ``NULL_TELEMETRY``, with no clock
read and no allocation per step. Tokens are bitwise the same either way.

**int8 KV** (``kv_quant=True``): K/V caches and pools hold int8 entries
with bf16 per-(token, kv head) scales, quantized at every write; slot
reset, page clears, copy-on-write and preemption treat the scale leaves
as they treat K/V, and the ``cuda`` backend attends through the int8 form
of the kernel (``paged_attention_quant``). MLA latent caches ignore it.

**Sharded serving** (``mesh='PxH'``, ``(P, H)`` or a
``launch.mesh.ServingMesh``; paged engines only): "shard storage,
replicate compute", as the JAX engine. Between steps every state leaf is
at rest in the layout of ``repro_torch.sharding`` — a P x H grid of
contiguous blocks on the mesh's devices, the pool's pages over ``'pool'``
(``kvpool.partition_pages``), K/V kv heads over ``'heads'``, a dimension
that does not divide replicated. Each tick (``step_once``) and each
``score`` call gathers the blocks into full leaves on the primary device
(``_rep_in``), runs the one-device code on them, and cuts them back into
blocks (``_shard_out``); so greedy tokens are bitwise the unsharded
engine's. The one partitioned computation is the attend: with the ``cuda``
backend it runs on ``CudaBackend(mesh)``, one ``paged_attention`` launch
per kv-head shard on that shard's device. Unlike JAX, fused maintenance
stays on: it runs on the gathered pool on the primary device. The engine's
``device`` must be the mesh's primary device, so the gathered pool must fit
there. Each tick copies the whole pool twice, and each layer's kv-head
slices once more: a faithful port of the layout, not a fast one.

**Slot buckets and per-step programs** (JAX's ``_bucket``,
``_slice_states`` and ``_build_programs``): each dispatch runs at the
smallest power-of-two bucket of slots, floor 8, that covers the highest
active slot, capped at ``max_slots`` (an engine of at most 8 slots always
runs full width). Tokens, positions, ``n_valid`` / ``lane_valid``,
temperatures and the page tables are cut to the bucket, and so are the
per-slot state leaves, as views (``_bucket_states``; pool leaves pass
whole), so a 256-slot engine serving 3 requests runs 8-wide steps and
``lanes_dispatched`` counts the bucket's lanes. Each step shape ``(path,
nb, T, want_logits)`` has a ``serving.programs.StepProgram`` (in
``self.programs``) with static input and output buffers. On a CUDA device
with the ``cuda`` backend and no mesh it captures its forward into a CUDA
graph on the shape's first step and replays it after; all programs of an
engine share one graph memory pool. Under a mesh (its gathered leaves are
new every tick) and with the ``reference`` backend on a card (its paged
write indexes by a boolean mask: a shape that depends on the data) every
step runs eagerly, as on the CPU; so does every step inside
``_eager_steps()``, the counterpart of ``jax.disable_jit()`` for tests and
``chip_smoke.py``. A failed capture or replay raises. The deferred clears
ride into a step as a fixed-width array of ``_pending_cap`` (64) page ids,
zero-padded (page 0 is the null page, whose clear is a no-op); a tick that
queues more flushes them eagerly, as JAX does.

**Segment-packed prefill** (``pack_prefill=True``, chunk size above 1;
JAX's prepacking): a chunk step bin-packs each active slot's segment of
``n_valid`` lanes, first-fit decreasing and never split, into a compact
``(R, T)`` grid (``_pack_layout``: R a power of two, at most the
bucket's width), staged with its ``attention.PackedLayout`` arrays into a
``(PACKED, nb, R, T, want_logits)`` program. Token-wise work runs on the
packed grid and each attention layer on the slot-major layout, so tokens
and ``score()`` logits are bitwise the unpacked engine's on the CPU
(``blocks.block_decode``); ``lanes_dispatched`` counts the packed grid.
Decode-only steps are not packed (their grid is already one lane a slot).

**Async double-buffered loop** (``async_loop=True``; not under a mesh,
ROADMAP A.3): ``step_once`` dispatches tick N's step and then commits tick
N-1's (``_PendingStep``), so the host's scheduling, admission and staging
of step N overlap the device's step N-1. Nothing on the dispatch path
reads the device: the program splices each decoding slot's previous
sampled token in on the device from ``_prev_nxt`` (``use_prev``), and on a
card copies its outputs into pinned memory behind an event at dispatch
(a replay's outputs are overwritten by the next run of the program).
Host-visible request state trails the device by one dispatch; ``run()``
and ``score()`` drain the pipeline. A slot whose pending lane ends its
request by ``max_new_tokens`` or ``max_seq`` is not scheduled; an EOS or a
non-finite lane runs one speculative lane, discarded at its commit by the
(request, ``admit_seq``) guard, as are lanes of slots cancelled, expired,
preempted or refilled in flight. A pending lane that lands on a ring
snapshot boundary is committed (the snapshot captured) before the slot's
next chunk is dispatched. Greedy tokens are bitwise the synchronous
loop's; sampled ones (temperature above 0) are not compared across loops,
as in JAX.

Not ported yet, and rejected with ``NotImplementedError``: the dense
engine under a mesh, a mesh with the async loop, and a mesh with a
recurrent or meta-token model (ROADMAP A.5).
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import paged_maintenance as PM
from repro_torch.launch.mesh import make_serving_mesh, resolve_device
from repro_torch.models.attention import cache_len
from repro_torch.models.attn_backend import CudaBackend, get_backend
from repro_torch.models.blocks import ATTN_KINDS, HYBRID_KINDS, kind_window
from repro_torch.models.model import Model, audio_backend
from repro_torch.models.transformer import (fused_rope_eligible, layer_plan,
                                            prime_meta_states)
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.kvpool import PrefixCache
from repro_torch.serving.programs import CHUNK, PACKED, STEP, StepProgram
from repro_torch.serving import telemetry as TM
from repro_torch.serving.telemetry import Histogram, latency_summary
from repro_torch.sharding import (gather_leaf, leaf_axes, shard_leaf,
                                  spec_for_shape)


class RequestStatus(str, enum.Enum):
    """Per-request lifecycle; ``FINISHED`` / ``FAILED`` / ``CANCELLED`` are
    terminal."""
    QUEUED = 'queued'
    PREFILLING = 'prefilling'
    DECODING = 'decoding'
    FINISHED = 'finished'
    FAILED = 'failed'
    CANCELLED = 'cancelled'
    PREEMPTED = 'preempted'


TERMINAL_STATUSES = frozenset({RequestStatus.FINISHED, RequestStatus.FAILED,
                               RequestStatus.CANCELLED})


class ScoringError(RuntimeError):
    """Raised by :meth:`ServingEngine.score` when a scoring request ends
    without its prompt logits; ``errors[i]`` is None or the reason,
    ``logits[i]`` whatever completed."""

    def __init__(self, errors, logits):
        self.errors = errors
        self.logits = logits
        bad = [f'prompt {i}: {e}' for i, e in enumerate(errors)
               if e is not None]
        super().__init__(f'scoring failed for {len(bad)}/{len(errors)} '
                         f'prompts ({"; ".join(bad)})')


# internal (engine-allocated) uids start far below any plausible caller uid
_INTERNAL_UID_BASE = -(10 ** 12)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                    # (P,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    return_logits: bool = False           # collect all-position prompt logits
    deadline_s: Optional[float] = None    # budget from submit time, seconds
    # filled by the engine:
    status: RequestStatus = RequestStatus.QUEUED
    error: Optional[str] = None           # why status == FAILED
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # monotonic-clock stamps: only differences are meaningful
    submit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    prompt_logits: Optional[np.ndarray] = None    # (P, V) if return_logits
    prefix_hit_tokens: int = 0            # prompt tokens served from cache
    preemptions: int = 0                  # times this request was preempted
    _logit_chunks: List[np.ndarray] = dataclasses.field(default_factory=list,
                                                        repr=False)
    _admit_fails: int = dataclasses.field(default=0, repr=False)
    _stuck_pos: int = dataclasses.field(default=-1, repr=False)
    _stuck: int = dataclasses.field(default=0, repr=False)
    _hold_until: int = dataclasses.field(default=0, repr=False)

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES


@dataclasses.dataclass
class _Lane:
    """Commit record of one dispatched lane: everything the commit needs,
    taken at dispatch time, so that later host changes (a preemption, a
    re-admission while the step is in flight) cannot skew it. The request
    and ``admit_seq`` guard against the slot having been vacated and
    refilled, even by the same request, before the commit: such a lane is
    discarded."""
    slot: int
    req: Request
    admit_seq: int
    consumed: int
    p_before: int           # stream index before this dispatch
    p_after: int            # ... and after (positions less meta tokens)
    pos_after: int          # the slot's position after this dispatch
    gen: bool               # the commit appends a sampled token


@dataclasses.dataclass
class _PendingStep:
    """One dispatched step awaiting its commit. ``nxt`` / ``finite`` /
    ``drops`` / ``logits`` are the program's outputs (bucket-wide; packed
    scoring logits are (R, T, V)), or, in the async loop on a CUDA device,
    pinned host copies of them that ``event`` marks done: the only device
    wait of the commit."""
    nxt: torch.Tensor
    finite: torch.Tensor
    drops: torch.Tensor
    logits: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event]
    lanes: List[_Lane]
    pk_row: Optional[np.ndarray]    # packed grid: each slot's logit row
    pk_off: Optional[np.ndarray]    # ... and column
    step_idx: int
    kind: Optional[str]             # telemetry step kind (None: off)
    times: Optional[list]           # the four dispatch-side phase seconds
    needs_sync: bool                # a lane lands on a snapshot boundary:
                                    # commit before the slot's next chunk


def _on_full_states(method):
    """Wrap an engine method that may read or write ``self.states`` (a
    tick, a scoring run): under a mesh, gather the leaves at rest into full
    leaves on the primary device first (``_rep_in``), run the one-device
    code on them, and cut them back into their blocks after
    (``_shard_out``). A nested call (``score`` runs ticks) runs inside the
    outer one's gather. With telemetry, the host seconds of the gather and
    the split go to ``_t_mesh`` (the tick's ``dispatch`` phase)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if self.mesh is None or self._gathered:
            return method(self, *args, **kwargs)
        tel = self.telemetry
        t0 = tel.now() if tel.enabled else 0.0
        self.states = self._rep_in(self.states)
        self._gathered = True
        self._index_states()
        if tel.enabled:
            self._t_mesh = tel.now() - t0
        try:
            return method(self, *args, **kwargs)
        finally:
            t0 = tel.now() if tel.enabled else 0.0
            self._gathered = False
            # they alias full leaves
            self._reset_plan = self._pools = self._snap_plan = None
            self.states = self._shard_out(self.states)
            if tel.enabled:
                self._t_mesh += tel.now() - t0
    return run


# > 0 inside _eager_steps(): every step runs eagerly
_eager_depth = 0


@contextlib.contextmanager
def _eager_steps():
    """Run every engine step inside the block eagerly: programs neither
    capture nor replay a CUDA graph (the counterpart of
    ``jax.disable_jit()``; tests and ``chip_smoke.py`` hold replays against
    it)."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


class ServingEngine:
    def __init__(self, model: Model, params, *, max_slots: int = 8,
                 max_seq: int = 512, precomputed=None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, kv_quant: bool = False,
                 chunk_size: int = 1, fused_gather_rope: bool = False,
                 prefix_cache: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, attn_backend: str = 'auto',
                 fault_injector: Optional[FaultInjector] = None,
                 admit_retry_steps: int = 8, pack_prefill: bool = False,
                 telemetry=False, mesh=None, async_loop: bool = False,
                 device: torch.device | str = 'cuda'):
        cfg = model.cfg
        self.model, self.params = model, params
        self.device = torch.device(device)
        self.max_slots, self.max_seq = max_slots, max_seq
        self.precomputed = precomputed
        self.attn_backend = get_backend(attn_backend, self.device)
        if cfg.arch_class == 'audio':
            chunk_size = 1   # enc-dec decode is one token per step by API
            if prefix_cache:
                raise ValueError('paged prefix caching is not supported for '
                                 'audio enc-dec decode')
            # 'auto' -> reference on every device; 'cuda' raises
            self.attn_backend = audio_backend(attn_backend, self.device)
        self.chunk_size = chunk_size
        self.paged = bool(prefix_cache)
        # mesh: None | 'PxH' | (P, H) | a ServingMesh, resolved (and
        # ValueError'd on impossible shapes) by make_serving_mesh
        self.mesh = make_serving_mesh(mesh)
        plan = layer_plan(cfg)
        # Hymba's meta tokens lead every slot's sequence: positions start
        # after them
        self._meta = cfg.num_meta_tokens
        if self.mesh is not None:
            if self._meta or any(k not in ATTN_KINDS for k in plan.kinds):
                raise NotImplementedError(
                    'ServingEngine(mesh=...) is ported for attention layers; '
                    'recurrent state and meta tokens under a mesh are not '
                    f'ported yet (ROADMAP A.5; layers: '
                    f'{sorted(set(plan.kinds))})')
            if not self.paged:
                raise NotImplementedError(
                    'ServingEngine(mesh=...) is ported for the paged engine '
                    '(prefix_cache=True); the dense engine under a mesh '
                    '(per-slot caches over the pool axis) is not ported yet')
            if resolve_device(self.device) != self.mesh.primary:
                raise ValueError(
                    f'the engine\'s device ({self.device}) must be the '
                    f'mesh\'s primary device ({self.mesh.primary}): weights, '
                    'compute and the gathered state live there')
            if async_loop:
                raise NotImplementedError(
                    'ServingEngine(mesh=..., async_loop=True) is not ported '
                    'yet (ROADMAP A.3): a mesh engine runs the synchronous '
                    'loop')
            if self.attn_backend.name == 'cuda':
                # the attend runs one kernel launch per kv-head shard
                self.attn_backend = CudaBackend(self.mesh)
        self._gathered = False
        # the async double-buffered loop: the dispatch awaiting its commit
        self.async_loop = bool(async_loop)
        self._pending: Optional[_PendingStep] = None
        # segment-packed prefill needs a chunk grid to pack into
        self.pack_prefill = bool(pack_prefill) and chunk_size > 1
        # ------------------------------------------------------ telemetry
        # False/None -> the shared no-op singleton (every site is guarded
        # by `if tel.enabled`), True -> a fresh recorder, or a Telemetry
        # shared between engines
        self.telemetry = TM.coerce(telemetry)
        tel = self.telemetry
        # request latency / TTFT back run()'s percentiles with telemetry off
        # too (one observation per request); with it on they are registry
        # series and ride every export
        if tel.enabled:
            self._lat_hist = tel.registry.histogram(TM.REQUEST_LATENCY)
            self._ttft_hist = tel.registry.histogram(TM.REQUEST_TTFT)
            self._cow_counter = tel.registry.counter(TM.KV_COW_COPIES)
            self._phase_h = {
                kind: {ph: tel.registry.histogram(
                    TM.STEP_PHASE, phase=ph, backend=self.attn_backend.name,
                    kind=kind) for ph in TM.PHASES}
                for kind in TM.STEP_KINDS}
            tel.registry.gauge(TM.QUEUE_DEPTH, fn=lambda: len(self.queue))
            self._overlap_h = tel.registry.histogram(
                TM.STEP_OVERLAP, backend=self.attn_backend.name) \
                if self.async_loop else None
        else:
            self._lat_hist = Histogram()
            self._ttft_hist = Histogram()
            self._cow_counter = None
            self._phase_h = None
            self._overlap_h = None
        self._t_radix = 0.0     # radix-lookup seconds within this tick
        self._t_mesh = 0.0      # the tick's gather + split seconds (mesh)
        # (kind, five phase seconds) of each step this tick committed
        self._step_obs: List[tuple] = []
        self.fault_injector = fault_injector
        self.page_size = page_size
        # the one-token path never fuses (paged mode has none: its T == 1
        # steps run the chunk path); ineligible layouts use the plain gather
        # (transformer.fused_rope_eligible)
        self.fused_gather_rope = bool(fused_gather_rope) \
            and (chunk_size > 1 or self.paged) \
            and fused_rope_eligible(precomputed, cfg)
        self.num_pages = 0
        self._sc_ring = 0
        self.kv: Optional[PrefixCache] = None
        # the layers that keep attention caches (pool leaves when paged)
        attn = [k for k in plan.kinds if k in ATTN_KINDS + HYBRID_KINDS]
        if self.paged:
            if self._meta:
                raise ValueError('paged prefix caching does not support '
                                 'meta-token architectures yet (the primed '
                                 'meta prefix would need template pages)')
            if max_seq % page_size:
                raise ValueError(f'max_seq ({max_seq}) must be a multiple of '
                                 f'page_size ({page_size}) so the paged '
                                 'virtual cache matches the dense cache '
                                 'length exactly')
            windows = [kind_window(cfg, k) for k in attn]
            # the ring of the windowed layers: the dense ring cache's length
            self._sc_ring = cache_len(cfg.window, max_seq, chunk_size) \
                if any(windows) else 0
            self._pages_lin = max_seq // page_size
            self._pages_ring = -(-self._sc_ring // page_size)
            # a layer whose state is rewritten in place (a ring, recurrent
            # or conv state) resumes a prefix only from the snapshot on its
            # radix node
            self._needs_snapshot = any(k != 'global' for k in plan.kinds)
            # which job lists a fused step needs: the tables its attention
            # layers use (none for a recurrent stack: its pool has no page
            # leaves, and no page kernel ever launches)
            self._ring_layers = any(windows)
            self._lin_layers = not all(windows)
            if num_pages is None:
                num_pages = 1 + max_slots * (self._pages_lin
                                             + self._pages_ring) \
                    + 8 * self._pages_lin
            # one admission needs its ring pages and a COW page, and the
            # first dispatch one linear page; below this floor nothing could
            # ever be admitted
            floor = 1 + self._pages_ring + 2
            if num_pages < floor:
                raise ValueError(f'num_pages ({num_pages}) cannot host even '
                                 f'one request: need >= {floor} '
                                 f'(null page + {self._pages_ring} ring '
                                 'pages + COW/linear headroom)')
            self.kv = PrefixCache(num_pages, page_size)
            if tel.enabled:
                self.kv.bind_telemetry(tel)
            self.num_pages = num_pages
        self.kv_quant = bool(kv_quant)
        self.states = model.make_states(
            max_slots, max_seq, dtype, chunk=chunk_size, device=self.device,
            num_pages=self.num_pages, page_size=page_size if self.paged else 0,
            kv_quant=self.kv_quant)
        if self._meta:
            # every slot starts from the primed meta prefix: run once here,
            # eagerly, 128 one-token steps at full width (never captured)
            with torch.no_grad():
                prime_meta_states(params, self.states, cfg, max_slots,
                                  attn_backend=self.attn_backend)
        self._paged_mask = model.paged_state_mask(self.kv_quant) \
            if self.paged else None
        # the template of a clean slot (JAX's ``_fresh``): a copy of every
        # per-slot leaf as made (and primed), which a slot reset copies its
        # rows from in place; pool leaves are cleared per page instead
        self._fresh = [leaf.clone() for leaf, _ in
                       self._slot_leaves(self.states)]
        if self.mesh is None:
            self._index_states()
        else:           # at rest in blocks; indexed while gathered
            self._reset_plan = self._pools = self._snap_plan = None
            self.states = self._shard_out(self.states)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.slot_pos = np.zeros(max_slots, np.int64)       # next position
        self.slot_next_tok = np.zeros(max_slots, np.int32)  # token to feed
        # the token stream a slot serves: prompt, or prompt + generated-so-far
        # for a resumed (previously preempted) request
        self.slot_stream: List[Optional[np.ndarray]] = [None] * max_slots
        self.slot_admit_seq = np.zeros(max_slots, np.int64)  # LIFO victim tie
        self.queue: List[Request] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.steps = 0
        self.ticks = 0      # step_once entries
        self._live_uids: set = set()
        self._internal_uid = _INTERNAL_UID_BASE
        self._admit_seq = 0
        self._admit_retry_steps = max(1, admit_retry_steps)
        self.preemptions = 0
        self.cow_copies = 0
        self.n_failed = 0
        self.n_cancelled = 0
        self.n_deadline = 0
        self.n_stalled = 0
        self.moe_token_drops = 0
        # chunk-grid utilization: lanes dispatched vs lanes carrying a token
        self.lanes_dispatched = 0
        self.lane_tokens = 0

        # ------------------------------------------------ per-slot paging
        # Deferred clear-on-alloc: with a fused_maintenance backend, freshly
        # allocated pages are queued here and ride into the next step as
        # PageTables.pending, where every layer's fused write clears them
        self._fused_maint = self.paged and bool(attn) \
            and self.attn_backend.fused_maintenance
        self._pending_clear: List[int] = []
        # the width of the pending array a step takes (a fixed shape);
        # past it _alloc_pages clears eagerly
        self._pending_cap = 64
        if self.paged:
            self._pt = np.zeros((max_slots, self._pages_lin), np.int32)
            self._rt = np.zeros((max_slots, max(self._pages_ring, 1)),
                                np.int32)
            self.slot_node = [None] * max_slots       # attached radix node
            self.slot_nblocks = np.zeros(max_slots, np.int32)
            self.slot_priv: List[List[int]] = [[] for _ in range(max_slots)]
            self.slot_ring: List[List[int]] = [[] for _ in range(max_slots)]
            self.slot_insert_at = np.full(max_slots, -1, np.int64)

        # ------------------------------------------------ per-step programs
        # one StepProgram per (path, nb, T, want_logits); CUDA graphs on a
        # CUDA device with the cuda backend and no mesh, in one shared pool
        self.programs: Dict[tuple, StepProgram] = {}
        self._graphs = self.device.type == 'cuda' and self.mesh is None \
            and self.attn_backend.name == 'cuda'
        self._graph_pool = torch.cuda.graph_pool_handle() if self._graphs \
            else None
        # the async loop's previous sampled tokens at a fixed address: every
        # program writes its nxt here and the next one splices it in
        self._prev_nxt = torch.zeros(max_slots, dtype=torch.int32,
                                     device=self.device) \
            if self.async_loop else None

    # ------------------------------------------------------ state layout
    def _layers(self, states):
        """(leaves, pool mask, stacked?) of every layer of a states tree;
        ``stacked``: the ``body`` part's leaves, stacked over the layers of
        a pattern slot."""
        mask = self._paged_mask
        for part, st in states.items():
            layers = st if isinstance(st, list) else [st]
            masks = [{}] * len(layers) if mask is None else \
                mask[part] if isinstance(st, list) else [mask[part]]
            for layer, lmask in zip(layers, masks):
                yield layer, lmask, part == 'body'

    def _slot_leaves(self, states):
        """(leaf, slot axis) of every per-slot leaf of a states tree, in
        walk order: caches of a dense engine, recurrent and conv state; not
        the page pool."""
        for layer, lmask, stacked in self._layers(states):
            for nm, leaf in layer.items():
                if not lmask.get(nm):
                    yield leaf, 1 if stacked else 0

    def _index_states(self) -> None:
        """Index the leaves of ``self.states`` (full leaves) that slot
        resets, page clears, copy-on-write and snapshots touch."""
        # (leaf, slot axis, template leaf) of every per-slot leaf, for slot
        # reset; the page pool is never slot-reset (pages are cleared when
        # they are allocated instead)
        self._reset_plan = [(leaf, axis, fresh) for (leaf, axis), fresh in
                            zip(self._slot_leaves(self.states), self._fresh)]
        # (pool leaves, reps) of every layer's page pool: reps > 0 for
        # leaves stacked over the layers of a pattern slot
        self._pools = []
        # (leaf, page or slot axis, pooled?) of every leaf, in the order of
        # a snapshot's tensors: one per leaf, stacked leaves included
        self._snap_plan = []
        for layer, lmask, stacked in self._layers(self.states):
            pool = {nm: leaf for nm, leaf in layer.items() if lmask.get(nm)}
            if pool:
                reps = next(iter(pool.values())).shape[0] if stacked else 0
                self._pools.append((pool, reps))
            axis = 1 if stacked else 0
            self._snap_plan += [(leaf, axis, bool(lmask.get(nm)))
                                for nm, leaf in layer.items()]

    def _map_states(self, states, fn):
        """A states tree of the same structure with ``fn(leaf, name,
        stacked, pooled)`` in place of every leaf."""
        out = {}
        for part, st in states.items():
            layers = [{nm: fn(leaf, nm, stacked, bool(lmask.get(nm)))
                       for nm, leaf in layer.items()}
                      for layer, lmask, stacked in self._layers({part: st})]
            out[part] = layers if isinstance(st, list) else layers[0]
        return out

    # -------------------------------------------------------- slot buckets
    def _bucket(self, active: List[int]) -> int:
        """Power-of-two slot-count bucket covering the highest active slot
        (floor 8, capped at max_slots), as JAX's. Engines with max_slots
        <= 8 always run the full width."""
        S = self.max_slots
        if S <= 8 or not active:
            return S
        nb = 8
        hi = max(active) + 1
        while nb < hi:
            nb *= 2
        return min(nb, S)

    def _bucket_states(self, nb: int):
        """The states a step of bucket ``nb`` runs on (JAX's
        ``_slice_states``): every per-slot leaf cut to its first ``nb``
        slots (``leaf[:, :nb]`` for the ``body`` leaves stacked over
        layers; each layer's ``leaf[r, :nb]`` is contiguous), pool leaves
        whole. Views: the forward writes the caches in place, so its writes
        land in the full leaves and JAX's ``_merge_states`` has no
        counterpart."""
        if nb == self.max_slots:
            return self.states
        return self._map_states(
            self.states, lambda leaf, _nm, stacked, pooled:
            leaf if pooled else leaf[:, :nb] if stacked else leaf[:nb])

    def _rep_in(self, states):
        """Gather every leaf at rest (``sharding.ShardedLeaf``) into the
        full leaf on the primary device: the 'replicate compute' half of
        the layout, so each step runs the exact one-device math."""
        return self._map_states(
            states, lambda leaf, *_: gather_leaf(leaf, self.device))

    def _shard_out(self, states):
        """Cut every full leaf into its blocks at rest on the mesh, in the
        layout of ``sharding.spec_for_shape`` (the JAX engine's
        ``_place_states`` and ``_shard_out`` in one)."""
        def place(x, name, stacked, pooled):
            spec = spec_for_shape(self.mesh, x.shape,
                                  leaf_axes(name, x.dim(), stacked, pooled))
            return shard_leaf(x, spec, self.mesh)
        return self._map_states(states, place)

    # ------------------------------------------------------------- plumbing
    def _validate(self, req: Request) -> Optional[str]:
        prompt = np.atleast_1d(np.asarray(req.prompt))
        if prompt.size == 0:
            return 'empty_prompt'
        if prompt.size + self._meta >= self.max_seq:
            return 'prompt_too_long'
        if req.max_new_tokens <= 0:
            return 'max_new_tokens_not_positive'
        return None

    def submit(self, req: Request) -> None:
        """Validate and enqueue one request. Malformed requests are marked
        ``FAILED`` with ``error`` set; a uid already live raises
        ``ValueError``."""
        req.submit_t = time.monotonic()
        tel = self.telemetry
        err = self._validate(req)
        if err is not None:
            req.status = RequestStatus.FAILED
            req.error = err
            req.finish_t = req.submit_t
            self.n_failed += 1
            if tel.enabled:
                tel.event(req.uid, TM.EV_SUBMIT, t=req.submit_t,
                          prompt_len=len(req.prompt))
                tel.event(req.uid, TM.EV_FAIL, t=req.finish_t, error=err)
            return
        if req.uid in self._live_uids:
            raise ValueError(f'uid {req.uid} is already live in this engine '
                             '(queued or in flight); pick a fresh uid')
        self._live_uids.add(req.uid)
        req.status = RequestStatus.QUEUED
        self.queue.append(req)
        if tel.enabled:
            tel.event(req.uid, TM.EV_SUBMIT, t=req.submit_t,
                      prompt_len=len(req.prompt))

    def _next_internal_uid(self) -> int:
        while True:
            self._internal_uid -= 1
            if self._internal_uid not in self._live_uids:
                return self._internal_uid

    def _terminate(self, req: Request, status: RequestStatus,
                   error: Optional[str] = None) -> None:
        req.status = status
        req.error = error
        req.finish_t = time.monotonic()
        if status is RequestStatus.FINISHED:
            req.done = True
            self._lat_hist.observe(req.finish_t - req.submit_t)
            self._ttft_hist.observe(req.first_token_t - req.submit_t)
        elif status is RequestStatus.FAILED:
            self.n_failed += 1
        elif status is RequestStatus.CANCELLED:
            self.n_cancelled += 1
        self._live_uids.discard(req.uid)
        tel = self.telemetry
        if tel.enabled:
            ev = {RequestStatus.FINISHED: TM.EV_FINISH,
                  RequestStatus.FAILED: TM.EV_FAIL,
                  RequestStatus.CANCELLED: TM.EV_CANCEL}[status]
            attrs = {'generated': len(req.generated)}
            if error is not None:
                attrs['error'] = error
            tel.event(req.uid, ev, t=req.finish_t, **attrs)

    def _vacate(self, slot: int) -> None:
        """Free one slot's scheduling state (and pages, in paged mode)."""
        self.slot_req[slot] = None
        self.slot_stream[slot] = None
        if self.paged:
            self._release_slot_pages(slot)

    def cancel(self, uid: int) -> bool:
        """Cancel a live request by uid, wherever it is: still queued, or
        in flight mid-prefill or mid-decode. Only host structures change
        (the slot, its page table and pages; no state is read, so a mesh
        needs no gather). Returns False if no live request has that uid
        (already terminal, or never submitted)."""
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                self.queue.pop(i)
                self._terminate(req, RequestStatus.CANCELLED)
                return True
        for s in range(self.max_slots):
            req = self.slot_req[s]
            if req is not None and req.uid == uid:
                self._vacate(s)
                self._terminate(req, RequestStatus.CANCELLED)
                return True
        return False

    def _check_deadlines(self) -> None:
        """Fail every live request whose budget expired (monotonic clock)."""
        now = time.monotonic()

        def expired(req: Request) -> bool:
            return req.deadline_s is not None \
                and now - req.submit_t > req.deadline_s

        for s in range(self.max_slots):
            req = self.slot_req[s]
            if req is not None and expired(req):
                self._vacate(s)
                self.n_deadline += 1
                self._terminate(req, RequestStatus.FAILED,
                                'deadline_exceeded')
        keep = []
        for req in self.queue:
            if expired(req):
                self.n_deadline += 1
                self._terminate(req, RequestStatus.FAILED,
                                'deadline_exceeded')
            else:
                keep.append(req)
        self.queue = keep

    def _reset_slot(self, slot: int) -> None:
        """Return one slot's rows to their initial state (empty caches,
        recurrent state as ``ssm.*_init_state`` makes it, the primed meta
        prefix) by copying them from the template, in place: no leakage
        across requests, and captured graphs keep their addresses."""
        for leaf, axis, fresh in self._reset_plan:
            leaf.select(axis, slot).copy_(fresh.select(axis, slot))

    # ------------------------------------------------------------ paged ops
    def _clear_pages(self, pages: List[int]) -> None:
        """Return pool pages to the null state on every layer, eagerly."""
        ids = torch.tensor(pages, dtype=torch.long, device=self.device)
        for cache, reps in self._pools:
            for nm, leaf in cache.items():
                if reps:
                    leaf[:, ids] = PM.leaf_fill(nm)
                else:
                    leaf[ids] = PM.leaf_fill(nm)

    def _cow_copy(self, src: int, dst: int, rem: int) -> None:
        """Copy rows [0, rem) of page src into page dst on every layer; the
        other rows of dst get the null state — what a cold prefill of those
        rem tokens would have left in a fresh page."""
        for cache, reps in self._pools:
            PM.cow_copy_cache(cache, src, dst, rem, reps=reps,
                              plain=not self._fused_maint)

    def _drop_pending(self, pages: List[int]) -> None:
        """Drop the deferred clears of pages that a copy has just written in
        full; a later clear would destroy them (every entry: a page freed
        and taken again in one step is listed twice)."""
        keep = set(pages)
        self._pending_clear = [p for p in self._pending_clear
                               if p not in keep]

    def _flush_pending(self) -> None:
        """Clear the deferred pages eagerly: needed before a snapshot
        capture reads raw page contents, and when the list outgrows the
        fixed-width array a step takes."""
        if self._pending_clear:
            self._clear_pages(self._pending_clear)
            self._pending_clear = []

    def _pending_array(self) -> np.ndarray:
        """The deferred clears as the (``_pending_cap``,) int32 array a
        step takes, zero-padded: page 0 is the null page, so a padding
        entry is the no-op clear of ``build_jobs``."""
        arr = np.zeros(self._pending_cap, np.int32)
        ids = self._pending_clear[:self._pending_cap]
        arr[:len(ids)] = ids
        return arr

    def _capture(self, slot: int) -> List[torch.Tensor]:
        """Snapshot of what a shared-page attach cannot restore: every pool
        leaf at the slot's ring pages (page axis 1 of a stacked leaf) and
        every per-slot leaf's row of the slot; one new tensor a leaf."""
        ring = torch.tensor(self.slot_ring[slot], dtype=torch.long,
                            device=self.device)
        return [leaf.index_select(axis, ring) if pooled
                else leaf.select(axis, slot).clone()
                for leaf, axis, pooled in self._snap_plan]

    def _restore(self, slot: int, snap: List[torch.Tensor]) -> None:
        """Copy a snapshot into the slot's ring pages and per-slot rows, in
        place; the snapshot stays as it is (it serves every hit)."""
        ring = torch.tensor(self.slot_ring[slot], dtype=torch.long,
                            device=self.device)
        for (leaf, axis, pooled), sn in zip(self._snap_plan, snap):
            if pooled:
                leaf.index_copy_(axis, ring, sn)
            else:
                leaf.select(axis, slot).copy_(sn)

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        if n == 0:
            return []
        pages = self.kv.alloc(n)
        if pages is None:
            return None
        if self._fused_maint:
            # clear-on-alloc is deferred: the ids ride into the next
            # dispatch as PageTables.pending, where every layer's fused
            # write folds the clear into first-write masking (or a clear job)
            self._pending_clear.extend(pages)
            if len(self._pending_clear) > self._pending_cap:
                self._flush_pending()       # past the fixed width: eagerly
        else:
            self._clear_pages(pages)
        return pages

    def _release_slot_pages(self, slot: int) -> None:
        if self.slot_node[slot] is not None:
            self.kv.release(self.slot_node[slot])
            self.slot_node[slot] = None
        if self.slot_priv[slot]:
            self.kv.free(self.slot_priv[slot])
            self.slot_priv[slot] = []
        if self.slot_ring[slot]:
            self.kv.free(self.slot_ring[slot])
            self.slot_ring[slot] = []
        self._pt[slot] = 0
        self._rt[slot] = 0
        self.slot_nblocks[slot] = 0
        self.slot_insert_at[slot] = -1

    def _admit_paged(self, slot: int, req: Request,
                     stream: np.ndarray) -> bool:
        """Prefix lookup + page attach for one admission. ``stream`` is the
        token stream to serve — the prompt, or prompt + generated-so-far
        for a resumed (preempted) request, whose published pages make the
        resume a prefix hit. Returns False if the pool cannot currently
        host the request (it goes back to the queue)."""
        ps = self.page_size
        P = len(stream)
        node, nblocks, pages = None, 0, []
        if not req.return_logits and P > 1:
            tel = self.telemetry
            r0 = tel.now() if tel.enabled else 0.0
            res = self.kv.match(stream, max_tokens=P - 1,
                                need_snapshot=self._needs_snapshot)
            if tel.enabled:
                self._t_radix += tel.now() - r0
            node, nblocks, pages = res.node, res.n_blocks, res.pages
        # pin the match before any allocation can trigger eviction
        self.kv.attach(node)
        ring = self._alloc_pages(self._pages_ring)
        if ring is None:
            self.kv.release(node)
            return False
        eff = nblocks * ps
        cow_page = None
        if not self._needs_snapshot and not req.return_logits:
            # copy-on-write: reuse the head of a cached block this prompt
            # stops short inside (or diverges from past its shared rows);
            # a snapshot holds the state at its node's boundary only
            tail_len = min(P - 1 - eff, ps - 1)
            if tail_len > 0:
                alloc = self._alloc_pages(1)
                if alloc is None:
                    self.kv.release(node)
                    self.kv.free(ring)
                    return False
                src = self.kv.find_extension(node, stream[eff:eff + tail_len])
                if src >= 0:
                    self._cow_copy(src, alloc[0], tail_len)
                    cow_page = alloc[0]
                    self.cow_copies += 1
                    if self.telemetry.enabled:
                        self._cow_counter.inc()
                        self.telemetry.event(
                            req.uid, TM.EV_COW, src_page=int(src),
                            dst_page=int(alloc[0]), rows=int(tail_len))
                    eff += tail_len
                    self._drop_pending([cow_page])
                else:
                    self.kv.free(alloc)
        self._reset_slot(slot)
        self.slot_ring[slot] = ring
        self._rt[slot, :len(ring)] = ring
        row = list(pages) + ([cow_page] if cow_page is not None else [])
        self._pt[slot, :len(row)] = row
        self.slot_nblocks[slot] = len(row)
        self.slot_node[slot] = node
        self.slot_priv[slot] = [cow_page] if cow_page is not None else []
        if eff:
            self.kv.hits += 1
            self.kv.hit_tokens += eff
            req.prefix_hit_tokens = eff
        elif not req.return_logits:
            self.kv.misses += 1
        if self._needs_snapshot and node is not None:
            # copy-on-attach: the ring as it stood after the node's tokens;
            # the copy wrote the ring pages in full, so their deferred
            # clears must go
            self._restore(slot, node.snapshot)
            self._drop_pending(ring)
        # where to publish this prompt's prefix: all its full pages, or,
        # with snapshots, the last page boundary before its final token
        if req.return_logits:
            self.slot_insert_at[slot] = -1
        elif self._needs_snapshot:
            target = ((P - 1) // ps) * ps
            self.slot_insert_at[slot] = target if target > eff else -1
        else:
            self.slot_insert_at[slot] = P if P // ps > nblocks else -1
        self.slot_pos[slot] = eff
        self.slot_next_tok[slot] = int(stream[eff])
        return True

    # ---------------------------------------------------------- preemption
    def _pick_victim(self, exclude=(),
                     protect_oldest: bool = True) -> Optional[int]:
        """Fewest decoded tokens first (cheapest work to redo), ties LIFO
        (most recently admitted). Scoring slots are never victims. With
        ``protect_oldest`` the longest-admitted in-flight request is immune,
        which guarantees progress: two requests that cannot coexist in the
        pool would otherwise preempt each other forever."""
        protected = None
        if protect_oldest:
            live = [(int(self.slot_admit_seq[s]), s)
                    for s in range(self.max_slots)
                    if self.slot_req[s] is not None]
            if live:
                protected = min(live)[1]
        best = None
        for s in range(self.max_slots):
            req = self.slot_req[s]
            if req is None or s in exclude or s == protected \
                    or req.return_logits:
                continue
            key = (len(req.generated), -int(self.slot_admit_seq[s]))
            if best is None or key < best[0]:
                best = (key, s)
        return None if best is None else best[1]

    def _publish(self, slot: int, tokens: np.ndarray, n_blocks: int) -> None:
        """Insert the slot's first ``n_blocks`` pages into the radix index
        and re-pin the slot to the inserted path. With snapshots the slot
        stands at that boundary, and the deepest node gets its capture."""
        snap = None
        if self._needs_snapshot:
            if self._fused_maint:
                self._flush_pending()   # the capture reads raw page contents
            snap = self._capture(slot)
        node, transferred = self.kv.insert(tokens, n_blocks,
                                           list(self._pt[slot, :n_blocks]),
                                           snapshot=snap)
        moved = set(transferred)
        self.slot_priv[slot] = [p for p in self.slot_priv[slot]
                                if p not in moved]
        self.kv.attach(node)
        self.kv.release(self.slot_node[slot])
        self.slot_node[slot] = node

    def _publish_preempted(self, slot: int) -> None:
        """Publish a preempted slot's fully written pages, so its resume is
        a prefix hit that recomputes only the uncached tail. Blocks may
        cover generated tokens too: radix keys are token values, and
        identical tokens at identical positions give identical pages. With
        snapshots only a slot at a page boundary publishes: a ring resumes
        only from the state at its node's boundary."""
        req = self.slot_req[slot]
        if req.return_logits:
            return                          # scoring resumes cold anyway
        pos = int(self.slot_pos[slot])
        n_blocks = pos // self.page_size
        if n_blocks <= 0 or (self._needs_snapshot
                             and pos != n_blocks * self.page_size):
            return
        stream = np.atleast_1d(np.asarray(req.prompt))
        if req.generated:
            stream = np.concatenate(
                [stream, np.asarray(req.generated, stream.dtype)])
        self._publish(slot, stream, n_blocks)

    def _preempt_slot(self, slot: int, hold: bool = False) -> None:
        """Evict one in-flight request from its slot and requeue it at the
        front, its full pages published first. ``hold`` delays its
        re-admission by ``admit_retry_steps`` ticks (a slot yielding to
        pool contention)."""
        req = self.slot_req[slot]
        if self.telemetry.enabled:
            self.telemetry.event(
                req.uid, TM.EV_PREEMPT, slot=slot,
                pos=int(self.slot_pos[slot]),
                generated=len(req.generated), hold=bool(hold))
        self._publish_preempted(slot)
        self._vacate(slot)
        req.status = RequestStatus.PREEMPTED
        req.preemptions += 1
        self.preemptions += 1
        req._logit_chunks = []              # scoring resumes from position 0
        if hold:
            req._hold_until = self.ticks + self._admit_retry_steps
        self.queue.insert(0, req)

    def _ensure_blocks(self, slot: int, end_pos: int) -> bool:
        """Allocate linear pages up to position ``end_pos``. When the pool
        is dry, preempt a victim, else yield this slot to the others, else
        (alone and making no progress) fail it as ``unschedulable``.
        Returns False iff ``slot`` no longer holds its request."""
        need = -(-end_pos // self.page_size)
        while self.slot_nblocks[slot] < need:
            alloc = self._alloc_pages(1)
            if alloc is not None:
                nb = int(self.slot_nblocks[slot])
                self._pt[slot, nb] = alloc[0]
                self.slot_priv[slot].append(alloc[0])
                self.slot_nblocks[slot] = nb + 1
                continue
            victim = self._pick_victim(exclude=(slot,))
            if victim is not None:
                self._preempt_slot(victim)
                continue
            if any(self.slot_req[s] is not None
                   for s in range(self.max_slots) if s != slot):
                # the others are untouchable (protected oldest / scoring):
                # yield to them; they free pages by finishing
                self._preempt_slot(slot, hold=True)
                return False
            req = self.slot_req[slot]
            pos = int(self.slot_pos[slot])
            if pos <= req._stuck_pos:
                req._stuck += 1
            else:
                req._stuck_pos, req._stuck = pos, 0
            if req._stuck >= 2:
                self._vacate(slot)
                self._terminate(req, RequestStatus.FAILED, 'unschedulable')
            else:
                self._preempt_slot(slot)
            return False
        return True

    def _maybe_insert(self, slot: int, p_before: int, p_after: int) -> None:
        """Publish a prefilled prompt's full pages into the radix index;
        with snapshots, once the slot stands exactly at its target."""
        P = int(self.slot_insert_at[slot])
        if P < 0:
            return
        if self._needs_snapshot:
            if p_after != P:
                return
        elif not (p_before < P <= p_after):
            return
        self._publish(slot, self.slot_stream[slot], P // self.page_size)
        self.slot_insert_at[slot] = -1

    # ------------------------------------------------------------ admission
    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue[0]
                if req._hold_until > self.ticks and any(
                        r is not None for r in self.slot_req):
                    return      # yielding to in-flight work; retry later
                req = self.queue.pop(0)
                req._hold_until = 0
                stream = np.atleast_1d(np.asarray(req.prompt))
                if req.generated:       # resuming a preempted request
                    stream = np.concatenate(
                        [stream, np.asarray(req.generated, stream.dtype)])
                if self.paged:
                    if not self._admit_with_retry(slot, req, stream):
                        return          # queue head parked (or failed)
                else:
                    self.slot_req[slot] = req
                    self.slot_pos[slot] = self._meta   # after meta tokens
                    self.slot_next_tok[slot] = int(stream[0])
                    self._reset_slot(slot)
                self.slot_stream[slot] = stream
                self.slot_admit_seq[slot] = self._admit_seq
                self._admit_seq += 1
                req.status = RequestStatus.PREFILLING
                req._admit_fails = 0
                if self.telemetry.enabled:
                    self.telemetry.event(
                        req.uid,
                        TM.EV_RESUME if req.preemptions else TM.EV_ADMIT,
                        slot=slot,
                        prefix_hit_tokens=int(req.prefix_hit_tokens))

    def _admit_with_retry(self, slot: int, req: Request,
                          stream: np.ndarray) -> bool:
        """Paged admission with bounded retries, then preemption of a
        victim, then ``FAILED('unschedulable')``. Returns False when
        admission should stop for this step (the queue head is parked, or
        was failed)."""
        while True:
            if self._admit_paged(slot, req, stream):
                self.slot_req[slot] = req
                return True
            req._admit_fails += 1
            if req._admit_fails <= self._admit_retry_steps:
                self.queue.insert(0, req)     # pool full: retry next step
                return False
            victim = self._pick_victim()
            if victim is None:
                victim = self._pick_victim(protect_oldest=False)
            if victim is not None:
                self._preempt_slot(victim)
                req._admit_fails = 0
                continue
            if any(r is not None for r in self.slot_req):
                self.queue.insert(0, req)     # only scoring slots in flight
                return False
            self._terminate(req, RequestStatus.FAILED, 'unschedulable')
            return False

    # ----------------------------------------------------------------- run
    def step_once(self) -> None:
        """One engine tick: fault hooks, deadlines, admission, one dispatch
        and a commit: of this tick's dispatch (the synchronous loop), or of
        the previous tick's (``async_loop``). With telemetry, each
        committed step's phase seconds are observed once the tick is over:
        under a mesh after the split back into blocks, which is charged,
        with the gather, to the tick's ``dispatch``."""
        outer = self.mesh is not None and not self._gathered
        self._tick()
        obs, self._step_obs = self._step_obs, []
        for kind, times in obs:
            if outer:
                times[3] += self._t_mesh
            for ph, t in zip(TM.PHASES, times):
                self._phase_h[kind][ph].observe(t)

    @_on_full_states
    def _tick(self) -> None:
        self.ticks += 1
        tel = self.telemetry
        obs = tel.enabled
        if obs:
            self._t_radix = 0.0
        t0 = tel.now() if obs else 0.0
        if self.fault_injector is not None:
            self.fault_injector.before_step(self)
        self._check_deadlines()
        if self._pending is not None and self._pending.needs_sync:
            # a pending lane landed on a snapshot boundary: its commit
            # captures the ring, so it lands before the slot's next chunk
            self._flush_async()
        self._admit()
        rec = self._dispatch(t0, obs)
        if self.async_loop:
            prev, self._pending = self._pending, rec
            if prev is not None:
                self._commit(prev)
        elif rec is not None:
            self._commit(rec)

    def _progress(self, slot: int) -> int:
        """Index in the slot's stream of the next token it consumes: its
        position less the meta tokens."""
        return int(self.slot_pos[slot]) - self._meta

    def _flush_async(self) -> None:
        """Commit the dispatch in flight, if any (the pending record is
        cleared first)."""
        rec, self._pending = self._pending, None
        if rec is not None:
            self._commit(rec)

    def _step_arrays(self, tokens: np.ndarray, n_valid: Optional[np.ndarray],
                     temps: np.ndarray, live: np.ndarray,
                     packed: Optional[Dict[str, np.ndarray]] = None,
                     use_prev: Optional[np.ndarray] = None
                     ) -> Dict[str, np.ndarray]:
        """The step's inputs on the host, at the bucket's width (``temps``):
        tokens (the bucket's rows, or the packed grid), positions, lane
        validity (``live``, the one-token path) or ``n_valid``, the
        temperatures and, packed, the six layout arrays of
        ``_pack_layout``; paged, the page tables and job lists; in the async
        loop, ``use_prev``."""
        nb = len(temps)
        pos = self.slot_pos[:nb].astype(np.int32)
        if n_valid is None:
            out = dict(tokens=tokens, pos=pos, lane_valid=live, temps=temps)
        else:
            out = dict(tokens=tokens, pos=pos, n_valid=n_valid, temps=temps)
            if packed is not None:
                out.update(packed)
            if self.paged:
                out.update(self._paged_host(pos, n_valid, tokens.shape[1]))
        if self.async_loop:
            out['use_prev'] = np.zeros(nb, np.int32) if use_prev is None \
                else use_prev[:nb].astype(np.int32)
        return out

    def _paged_host(self, pos: np.ndarray, n_valid: np.ndarray,
                    T: int) -> Dict[str, np.ndarray]:
        """The step's page-table inputs on the host: the bucket's rows of
        the linear and ring tables and, with fused maintenance, the pending
        array (``_pending_array``), the chunk positions and a job list for
        each table that a layer writes through (built once here and shared
        by the layers of that table). Each list carries the whole pending
        array: every layer clears the pending pages of its own pool."""
        nb = len(pos)
        pt, rt = self._pt[:nb], self._rt[:nb]
        out = dict(pt=pt, rt=rt)
        if not self._fused_maint:
            return out
        pending = self._pending_array()
        out.update(pending=pending, pos_t=PM.chunk_positions(
            torch.from_numpy(pos), T).numpy())
        for name, used, table, Sc in (
                ('jobs', self._lin_layers, pt, self.max_seq),
                ('ring_jobs', self._ring_layers, rt, self._sc_ring)):
            if used:
                out[name] = PM.build_jobs(
                    torch.from_numpy(pos), torch.from_numpy(n_valid),
                    torch.from_numpy(table), Sc, self.page_size, T,
                    torch.from_numpy(pending)).numpy()
        return out

    def _pack_layout(self, tokens: np.ndarray, n_valid: np.ndarray):
        """Bin-pack this step's per-slot segments into a compact (R, T)
        grid, as JAX's: first-fit decreasing over the active slots (each
        contributes one contiguous segment of ``n_valid[s]`` lanes, never
        split across rows, longest first, ties by slot), R rounded up to a
        power of two (at most log2(nb) + 1 packed shapes) and capped at the
        bucket's width. -> (packed tokens (R, T), the six layout arrays of
        ``attention.PackedLayout`` as int32 numpy arrays, ``seg_row``,
        ``seg_off``): slot ``s``'s lanes sit at ``(seg_row[s], seg_off[s]
        .. seg_off[s] + n_valid[s] - 1)``."""
        S, T = tokens.shape
        order = sorted((s for s in range(S) if n_valid[s] > 0),
                       key=lambda s: (-int(n_valid[s]), s))
        seg_row = np.zeros(S, np.int32)
        seg_off = np.zeros(S, np.int32)
        space: List[int] = []              # free lanes per packed row
        for s in order:
            ln = int(n_valid[s])
            for r, room in enumerate(space):
                if room >= ln:
                    seg_row[s], seg_off[s] = r, T - room
                    space[r] = room - ln
                    break
            else:
                seg_row[s], seg_off[s] = len(space), 0
                space.append(T - ln)
        R = 1
        while R < max(1, len(space)):
            R *= 2
        R = min(R, S)
        ptoks = np.zeros((R, T), np.int32)
        lanes = {nm: np.zeros((R, T), np.int32)
                 for nm in ('lane_slot', 'lane_local', 'lane_pos',
                            'lane_valid')}
        for s in order:
            ln = int(n_valid[s])
            r, o = int(seg_row[s]), int(seg_off[s])
            ptoks[r, o:o + ln] = tokens[s, :ln]
            lanes['lane_slot'][r, o:o + ln] = s
            lanes['lane_local'][r, o:o + ln] = np.arange(ln)
            lanes['lane_pos'][r, o:o + ln] = int(self.slot_pos[s]) \
                + np.arange(ln)
            lanes['lane_valid'][r, o:o + ln] = 1
        layout = dict(seg_row=seg_row, seg_off=seg_off, **lanes)
        return ptoks, layout, seg_row, seg_off

    def _dispatch(self, t0: float, obs: bool) -> Optional[_PendingStep]:
        """Build this tick's lanes, cut them to the slot bucket (packed
        into a compact grid with ``pack_prefill``), stage them into the
        step shape's program and run it; advance the slots' positions. Reads
        nothing back from the device. -> the commit record, or None when
        nothing was dispatched.

        In the async loop one dispatch is in flight: each decoding slot
        whose pending lane samples a token gets that token spliced in on
        the device (``use_prev``); a slot whose pending lane ends its
        request by ``max_new_tokens`` or ``max_seq`` is not scheduled; an
        EOS or a non-finite lane runs one speculative lane, discarded at
        its commit."""
        tel = self.telemetry
        active = [s for s in range(self.max_slots)
                  if self.slot_req[s] is not None]
        pend = self._pending
        use_prev = None
        if pend is not None:
            use_prev = np.zeros(self.max_slots, bool)
            skip = set()
            for ln in pend.lanes:
                s = ln.slot
                if self.slot_req[s] is not ln.req \
                        or int(self.slot_admit_seq[s]) != ln.admit_seq \
                        or not ln.gen:
                    continue
                use_prev[s] = True
                if len(ln.req.generated) + 1 >= ln.req.max_new_tokens \
                        or int(self.slot_pos[s]) + 1 >= self.max_seq:
                    skip.add(s)
                    use_prev[s] = False
            active = [s for s in active if s not in skip]
        if not active:
            return None
        step_idx = self.steps
        prefilling = self.chunk_size > 1 and any(
            len(self.slot_stream[s]) - self._progress(s) > 1
            for s in active)
        if prefilling or self.paged:
            # paged mode always runs the chunk-shaped step; its T == 1 case
            # is the decode step
            T = self.chunk_size if prefilling else 1
            tokens = np.zeros((self.max_slots, T), np.int32)
            n_valid = np.zeros(self.max_slots, np.int32)
            for s in active:
                if self.slot_req[s] is None:
                    continue      # preempted by an earlier slot's _ensure
                stream = self.slot_stream[s]
                p = self._progress(s)
                # a prefilling slot takes up to T prompt tokens, a decoding
                # slot its one sampled token
                take = min(T, len(stream) - p) if p < len(stream) else 1
                if self.paged and self._needs_snapshot \
                        and p < self.slot_insert_at[s]:
                    # land exactly on the snapshot boundary, so that the
                    # capture is the state after `target` tokens
                    take = min(take, int(self.slot_insert_at[s]) - p)
                if self.paged and not self._ensure_blocks(
                        s, int(self.slot_pos[s]) + take):
                    continue      # slot preempted/failed: lane stays empty
                if p < len(stream):
                    tokens[s, :take] = stream[p:p + take]
                else:
                    tokens[s, 0] = self.slot_next_tok[s]
                n_valid[s] = take
            # a preemption above may have vacated an already-scheduled lane
            for s in range(self.max_slots):
                if self.slot_req[s] is None and n_valid[s]:
                    tokens[s] = 0
                    n_valid[s] = 0
            if use_prev is not None:
                # ... or a slot with a pending token
                for s in range(self.max_slots):
                    if self.slot_req[s] is None:
                        use_prev[s] = False
            active = [s for s in active
                      if self.slot_req[s] is not None and n_valid[s] > 0]
            if not active:
                return None       # everything was preempted this step
            lane_n = n_valid
            if prefilling and max(int(n_valid[s]) for s in active) <= 1:
                # the prefilling slots were all preempted: narrow back to
                # the T == 1 grid (the chunk path's T == 1 case)
                prefilling = False
                if not self.paged:
                    n_valid = None
                tokens = tokens[:, :1]
            consumed = n_valid if n_valid is not None \
                else np.ones(self.max_slots, np.int32)
        else:
            tokens = self.slot_next_tok[:, None].copy()
            for s in active:
                # a prefilling slot's token from its stream: in the async
                # loop slot_next_tok is set one commit late
                p = self._progress(s)
                if p < len(self.slot_stream[s]):
                    tokens[s, 0] = self.slot_stream[s][p]
            n_valid = None
            lane_n = consumed = np.ones(self.max_slots, np.int32)
        kind = None
        if obs:
            n_pre = 0
            for s in active:
                p = self._progress(s)
                if p < len(self.slot_stream[s]):
                    n_pre += 1
                    tel.event(self.slot_req[s].uid, TM.EV_PREFILL_CHUNK,
                              step=step_idx, pos=p, n=int(lane_n[s]))
            kind = ('mixed' if 0 < n_pre < len(active)
                    else ('prefill' if n_pre else 'decode'))
            t1 = tel.now()
        # recomputed from the surviving lanes: a step whose only scoring
        # slot was preempted runs without the all-lane head
        want_logits = any(
            self.slot_req[s].return_logits
            and self._progress(s) < len(self.slot_stream[s])
            for s in active)
        # the slot bucket: every lane at or past nb is empty
        nb = self._bucket(active)
        tokens = tokens[:nb]
        layout = pk_row = pk_off = None
        if n_valid is not None:
            n_valid = n_valid[:nb]
            if self.pack_prefill and prefilling:
                tokens, layout, pk_row, pk_off = \
                    self._pack_layout(tokens, n_valid)
            self.lanes_dispatched += int(tokens.size)
            self.lane_tokens += int(n_valid.sum())
        temps = np.array([(r.temperature if r is not None else 0.0)
                          for r in self.slot_req[:nb]], np.float32)
        live = np.zeros(nb, np.int32)
        live[active] = 1
        arrays = self._step_arrays(tokens, n_valid, temps, live, layout,
                                   use_prev)
        if layout is not None:
            key = (PACKED, nb, tokens.shape[0], tokens.shape[1], want_logits)
        else:
            key = (STEP if n_valid is None else CHUNK, nb, tokens.shape[1],
                   want_logits)
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = StepProgram(self, key, arrays)
        prog.stage(arrays)
        if obs:
            t2 = tel.now()
        out = prog.run(self._graphs and not _eager_depth)
        event = None
        if self.async_loop and self.device.type == 'cuda':
            # the commit comes after the next dispatch, which may rerun
            # this program over its static outputs: copy them out now
            out, event = prog.copy_out(out)
        nxt, finite, logits, drops = out
        times = None
        if obs:
            t3 = tel.now()
            times = [max(0.0, t1 - t0 - self._t_radix), self._t_radix,
                     t2 - t1, t3 - t2]
            if self._overlap_h is not None and pend is not None:
                # host scheduling done while the previous dispatch was
                # still uncommitted: the double buffering's gain
                self._overlap_h.observe(max(0.0, t2 - t0))
        self._pending_clear = []
        lanes = []
        needs_sync = False
        for s in active:
            c = int(consumed[s])
            p_before = self._progress(s)
            self.slot_pos[s] += c
            p_after = self._progress(s)
            lanes.append(_Lane(slot=s, req=self.slot_req[s],
                               admit_seq=int(self.slot_admit_seq[s]),
                               consumed=c, p_before=p_before,
                               p_after=p_after,
                               pos_after=int(self.slot_pos[s]),
                               gen=p_after >= len(self.slot_stream[s])))
            if self.paged and self._needs_snapshot \
                    and p_after == int(self.slot_insert_at[s]):
                needs_sync = True
        self.steps += 1
        return _PendingStep(nxt=nxt, finite=finite, drops=drops,
                            logits=logits, event=event, lanes=lanes,
                            pk_row=pk_row, pk_off=pk_off, step_idx=step_idx,
                            kind=kind, times=times, needs_sync=needs_sync)

    def _commit(self, rec: _PendingStep) -> None:
        """Bring the step's tokens to the host (the device wait: the
        ``.cpu()`` of the outputs, or in the async loop on a card the event
        of their copies) and commit them: prompt logits, radix publishes,
        first/next tokens, terminations, the MoE drop count. Lanes whose
        slot was vacated or refilled since the dispatch are discarded.
        Lanes the fault injector poisons for ``rec.step_idx`` count as
        non-finite. With telemetry, appends the step's kind and five phase
        seconds to ``_step_obs``."""
        tel = self.telemetry
        obs = rec.kind is not None
        t3 = tel.now() if obs else 0.0
        if rec.event is not None:
            rec.event.synchronize()
        nxt = rec.nxt.cpu().numpy()
        self.moe_token_drops += int(rec.drops)
        bad = ~rec.finite.cpu().numpy()
        if self.fault_injector is not None:
            for s in self.fault_injector.poison_lanes(self, rec.step_idx):
                if 0 <= s < len(bad):
                    bad[s] = True
        logits = None if rec.logits is None \
            else rec.logits.float().cpu().numpy()
        for ln in rec.lanes:
            s, req = ln.slot, ln.req
            if self.slot_req[s] is not req \
                    or int(self.slot_admit_seq[s]) != ln.admit_seq:
                continue                # stale speculative lane: discard
            if bad[s]:
                self._vacate(s)
                self._terminate(req, RequestStatus.FAILED, 'nonfinite_logits')
                continue
            stream = self.slot_stream[s]
            if self.paged:
                self._maybe_insert(s, ln.p_before, ln.p_after)
            if req.return_logits and ln.p_before < len(stream):
                # the slot's lanes 0..consumed-1 hold logits for
                # stream[p_before:p_after]: row s, or on the packed grid
                # row pk_row[s] from column pk_off[s]
                if rec.pk_row is not None:
                    row, off = int(rec.pk_row[s]), int(rec.pk_off[s])
                    req._logit_chunks.append(
                        logits[row, off:off + ln.consumed].copy())
                else:
                    req._logit_chunks.append(logits[s, :ln.consumed].copy())
                if ln.p_after >= len(stream):
                    req.prompt_logits = np.concatenate(req._logit_chunks, 0)
                    req._logit_chunks = []
            if ln.p_after < len(stream):             # still prefilling
                self.slot_next_tok[s] = int(stream[ln.p_after])
                continue
            req.status = RequestStatus.DECODING
            tok = int(nxt[s])
            if not req.generated:
                req.first_token_t = time.monotonic()
                if obs:
                    tel.event(req.uid, TM.EV_FIRST_TOKEN,
                              t=req.first_token_t, step=rec.step_idx,
                              token=tok)
            elif obs:
                tel.event(req.uid, TM.EV_DECODE_STEP, step=rec.step_idx,
                          token=tok)
            req.generated.append(tok)
            self.slot_next_tok[s] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if hit_eos or len(req.generated) >= req.max_new_tokens \
                    or ln.pos_after + 1 >= self.max_seq:
                self._vacate(s)
                self._terminate(req, RequestStatus.FINISHED)
        if obs:
            self._step_obs.append((rec.kind,
                                   rec.times + [tel.now() - t3]))

    def run(self, max_iters: int = 100_000) -> Dict[str, float]:
        """Drive the engine until all submitted work is terminal or
        ``max_iters`` steps elapse; still-queued work is then marked
        ``FAILED('stalled')``. Returns a report with latency percentiles
        (keys omitted until a request finished)."""
        it = 0
        while (self.queue or any(r is not None for r in self.slot_req)
               or self._pending is not None) and it < max_iters:
            self.step_once()
            it += 1
        stalled = 0
        if it >= max_iters and self.queue:
            for req in self.queue:
                self._terminate(req, RequestStatus.FAILED, 'stalled')
                stalled += 1
            self.queue = []
            self.n_stalled += stalled
        out = {'iters': it, 'stalled': stalled,
               'in_flight': sum(r is not None for r in self.slot_req),
               'preemptions': self.preemptions,
               'failed': self.n_failed,
               'cancelled': self.n_cancelled,
               'deadline_exceeded': self.n_deadline}
        if self._lat_hist.count:
            out['p50_latency_s'] = self._lat_hist.percentile(50)
            out['p99_latency_s'] = self._lat_hist.percentile(99)
        if self._ttft_hist.count:
            out['p50_ttft_s'] = self._ttft_hist.percentile(50)
            out['p99_ttft_s'] = self._ttft_hist.percentile(99)
        return out

    @_on_full_states
    def score(self, prompts: List[np.ndarray]) -> List[np.ndarray]:
        """All-position logits of each prompt: ``out[i][t]`` is the
        next-token distribution after ``prompts[i][t]``. Raises
        :class:`ScoringError` if any prompt ends without its logits. Under
        a mesh the whole scoring run works on one gather of the state."""
        reqs = [Request(uid=self._next_internal_uid(),
                        prompt=np.asarray(p, np.int32),
                        max_new_tokens=1, return_logits=True)
                for p in prompts]
        for r in reqs:
            self.submit(r)
        self.run()
        if any(r.status is not RequestStatus.FINISHED
               or r.prompt_logits is None for r in reqs):
            errors = [None if (r.status is RequestStatus.FINISHED
                               and r.prompt_logits is not None)
                      else (r.error or r.status.value) for r in reqs]
            raise ScoringError(errors, [r.prompt_logits for r in reqs])
        return [r.prompt_logits for r in reqs]

    def metrics(self) -> Dict:
        """Structured snapshot of the telemetry registry: counters, gauges,
        and histogram summaries (count/sum/mean/min/max/p50/p90/p99 and the
        nonzero buckets). ``{'enabled': False}`` when telemetry is off."""
        return self.telemetry.snapshot()

    def stats(self, requests: List[Request]) -> Dict[str, float]:
        """Aggregate statistics over ``requests`` plus engine counters;
        latency/TTFT keys are omitted when they have no samples. Paged
        engines add the pool's counters (``kvpool.PrefixCache.stats``),
        ``cow_copies`` and ``ttft_on_hit_s``."""
        done = [r for r in requests if r.done]
        lat = [r.finish_t - r.submit_t for r in done]
        ttft = [r.first_token_t - r.submit_t for r in done if r.first_token_t]
        hit_ttft = [r.first_token_t - r.submit_t for r in done
                    if r.first_token_t and r.prefix_hit_tokens]
        out = {
            'completed': len(done),
            'tokens': sum(len(r.generated) for r in done),
            'engine_steps': self.steps,
            'moe_token_drops': self.moe_token_drops,
            'lanes_dispatched': self.lanes_dispatched,
            'lane_tokens': self.lane_tokens,
            'prefill_lane_utilization':
                self.lane_tokens / self.lanes_dispatched
                if self.lanes_dispatched else 0.0,
            'preemptions': self.preemptions,
            'failed': self.n_failed,
            'cancelled': self.n_cancelled,
            'deadline_exceeded': self.n_deadline,
            'stalled': self.n_stalled,
        }
        out.update(latency_summary('latency_s', lat))
        out.update(latency_summary('ttft_s', ttft))
        if self.kv is not None:
            out.update(self.kv.stats())
            out[TM.KV_COW_COPIES] = self.cow_copies
            out.update(latency_summary('ttft_on_hit_s', hit_ttft))
        return out
