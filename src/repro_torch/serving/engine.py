"""Batched serving engine: continuous batching with chunked prefill over
dense per-slot KV caches — the dense, synchronous path of
``repro/serving/engine.py``'s ``ServingEngine``.

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

**Attention backend** (``attn_backend='auto' | 'reference' | 'cuda'``):
``'auto'`` (the default) takes the ``cuda`` kernel backend on a CUDA
device and the plain ``reference`` backend on the CPU
(``repro_torch.models.attn_backend``). Greedy tokens of the two agree
wherever logits are not within the kernel tolerance of a tie.

**Requests** follow ``QUEUED -> PREFILLING -> DECODING -> FINISHED``.
Malformed submissions (empty prompt, prompt that cannot fit ``max_seq``,
``max_new_tokens <= 0``) are ``FAILED`` at submit with ``error`` set;
duplicate live uids raise ``ValueError``; ``deadline_s`` is enforced at
every step on the monotonic clock; a lane whose sampled logits are not
finite fails only its request (``'nonfinite_logits'``); ``run()`` marks
work still queued when its budget expires ``FAILED('stalled')``.
``score()`` returns all-position prompt logits (logits on demand).

Not ported yet, and rejected with ``NotImplementedError``: the paged KV
pool and prefix cache, device meshes, the async host loop, segment-packed
prefill, the int8 KV cache, telemetry recording and fault injection.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.attn_backend import get_backend
from repro_torch.models.model import Model
from repro_torch.models.transformer import fused_rope_eligible, lm_logits
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.telemetry import Histogram, latency_summary


class RequestStatus(str, enum.Enum):
    """Per-request lifecycle; ``FINISHED`` / ``FAILED`` / ``CANCELLED`` are
    terminal."""
    QUEUED = 'queued'
    PREFILLING = 'prefilling'
    DECODING = 'decoding'
    FINISHED = 'finished'
    FAILED = 'failed'
    CANCELLED = 'cancelled'


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
    _logit_chunks: List[np.ndarray] = dataclasses.field(default_factory=list,
                                                        repr=False)


@dataclasses.dataclass
class _Lane:
    """Commit record of one dispatched lane."""
    slot: int
    req: Request
    consumed: int
    p_before: int           # stream position before this dispatch
    p_after: int            # ... and after


class ServingEngine:
    def __init__(self, model: Model, params, *, max_slots: int = 8,
                 max_seq: int = 512, precomputed=None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, kv_quant: bool = False,
                 chunk_size: int = 1, fused_gather_rope: bool = False,
                 prefix_cache: bool = False, attn_backend: str = 'auto',
                 fault_injector=None, pack_prefill: bool = False,
                 telemetry: bool = False, mesh=None, async_loop: bool = False,
                 device: torch.device | str = 'cuda'):
        unported = {'prefix_cache': prefix_cache, 'mesh': mesh,
                    'async_loop': async_loop, 'pack_prefill': pack_prefill,
                    'kv_quant': kv_quant, 'telemetry': telemetry,
                    'fault_injector': fault_injector}
        for name, val in unported.items():
            if val is not None and val is not False:
                raise NotImplementedError(
                    f'ServingEngine({name}=...) is not ported yet')
        self.model, self.params = model, params
        self.device = torch.device(device)
        self.max_slots, self.max_seq = max_slots, max_seq
        self.precomputed = precomputed
        self.attn_backend = get_backend(attn_backend, self.device)
        self.chunk_size = chunk_size
        # the one-token path never fuses; ineligible layouts use the plain
        # gather (transformer.fused_rope_eligible)
        self.fused_gather_rope = bool(fused_gather_rope) and chunk_size > 1 \
            and fused_rope_eligible(precomputed, model.cfg)
        self.states = model.make_states(max_slots, max_seq, dtype,
                                        chunk=chunk_size, device=self.device)
        # (leaf, slot axis, fresh value) of every cache leaf, for slot reset
        self._reset_plan = []
        for part, st in self.states.items():
            for layer in (st if isinstance(st, list) else [st]):
                for nm, leaf in layer.items():
                    self._reset_plan.append(
                        (leaf, 1 if part == 'body' else 0,
                         -1 if nm == 'pos' else 0))
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.slot_pos = np.zeros(max_slots, np.int64)       # next position
        self.slot_next_tok = np.zeros(max_slots, np.int32)  # token to feed
        self.slot_stream: List[Optional[np.ndarray]] = [None] * max_slots
        self.queue: List[Request] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.steps = 0
        self._live_uids: set = set()
        self._internal_uid = _INTERNAL_UID_BASE
        self.n_failed = 0
        self.n_deadline = 0
        self.n_stalled = 0
        # chunk-grid utilization: lanes dispatched vs lanes carrying a token
        self.lanes_dispatched = 0
        self.lane_tokens = 0
        self._lat_hist = Histogram()
        self._ttft_hist = Histogram()

    # ------------------------------------------------------------- plumbing
    def _validate(self, req: Request) -> Optional[str]:
        prompt = np.atleast_1d(np.asarray(req.prompt))
        if prompt.size == 0:
            return 'empty_prompt'
        if prompt.size >= self.max_seq:
            return 'prompt_too_long'
        if req.max_new_tokens <= 0:
            return 'max_new_tokens_not_positive'
        return None

    def submit(self, req: Request) -> None:
        """Validate and enqueue one request. Malformed requests are marked
        ``FAILED`` with ``error`` set; a uid already live raises
        ``ValueError``."""
        req.submit_t = time.monotonic()
        err = self._validate(req)
        if err is not None:
            req.status = RequestStatus.FAILED
            req.error = err
            req.finish_t = req.submit_t
            self.n_failed += 1
            return
        if req.uid in self._live_uids:
            raise ValueError(f'uid {req.uid} is already live in this engine '
                             '(queued or in flight); pick a fresh uid')
        self._live_uids.add(req.uid)
        req.status = RequestStatus.QUEUED
        self.queue.append(req)

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
        self._live_uids.discard(req.uid)

    def _vacate(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.slot_stream[slot] = None

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
        """Return one slot's cache rows to the empty state (zeros,
        ``pos == -1``) in place: no leakage across requests."""
        for leaf, axis, fill in self._reset_plan:
            leaf.select(axis, slot).fill_(fill)

    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                stream = np.atleast_1d(np.asarray(req.prompt))
                self.slot_req[slot] = req
                self.slot_pos[slot] = 0
                self.slot_next_tok[slot] = int(stream[0])
                self._reset_slot(slot)
                self.slot_stream[slot] = stream
                req.status = RequestStatus.PREFILLING

    # ----------------------------------------------------------------- run
    def step_once(self) -> None:
        """One engine tick: deadlines, admission, one dispatch, commit."""
        self._check_deadlines()
        self._admit()
        rec = self._dispatch()
        if rec is not None:
            self._commit(*rec)

    @torch.no_grad()
    def _forward(self, tokens: np.ndarray, n_valid: Optional[np.ndarray],
                 temps: torch.Tensor, want_logits: bool):
        """Run one step on the device -> (sampled tokens (B,), per-lane
        finiteness (B,), all-lane logits (B, T, V) or None)."""
        dev, cfg = self.device, self.model.cfg
        tok = torch.from_numpy(tokens).to(dev)
        pos = torch.from_numpy(self.slot_pos.astype(np.int32)).to(dev)
        kw = dict(precomputed=self.precomputed,
                  attn_backend=self.attn_backend)
        if n_valid is None:
            logits, _ = self.model.decode_step(self.params, tok, self.states,
                                               pos, **kw)         # (B,1,V)
            all_logits = logits if want_logits else None
        else:
            nv = torch.from_numpy(n_valid).to(dev)
            h, _ = self.model.decode_step(
                self.params, tok, self.states, pos, n_valid=nv,
                return_hidden=True, fused_gather_rope=self.fused_gather_rope,
                **kw)
            # head only on each slot's last valid lane, not all T lanes
            last = (nv.long() - 1).clamp(min=0)
            h_last = h[torch.arange(h.shape[0], device=dev), last][:, None]
            logits = lm_logits(self.params, h_last, cfg)          # (B,1,V)
            all_logits = lm_logits(self.params, h, cfg) if want_logits \
                else None
        nxt = sample_tokens(logits[:, 0], self.generator, temps)
        finite = torch.isfinite(logits).all(dim=2).all(dim=1)
        return nxt, finite, all_logits

    def _dispatch(self):
        active = [s for s in range(self.max_slots)
                  if self.slot_req[s] is not None]
        if not active:
            return None
        prefilling = self.chunk_size > 1 and any(
            len(self.slot_stream[s]) - int(self.slot_pos[s]) > 1 for s in active)
        want_logits = any(
            self.slot_req[s].return_logits
            and int(self.slot_pos[s]) < len(self.slot_stream[s])
            for s in active)
        temps = torch.tensor(
            [(r.temperature if r is not None else 0.0) for r in self.slot_req],
            dtype=torch.float32, device=self.device)
        if prefilling:
            T = self.chunk_size
            tokens = np.zeros((self.max_slots, T), np.int32)
            n_valid = np.zeros(self.max_slots, np.int32)
            for s in active:
                stream = self.slot_stream[s]
                p = int(self.slot_pos[s])
                if p < len(stream):                  # prefilling slot
                    take = min(T, len(stream) - p)
                    tokens[s, :take] = stream[p:p + take]
                else:                                # decoding slot: 1 token
                    take = 1
                    tokens[s, 0] = self.slot_next_tok[s]
                n_valid[s] = take
            consumed = n_valid
            self.lanes_dispatched += int(tokens.size)
            self.lane_tokens += int(n_valid.sum())
        else:
            tokens = self.slot_next_tok[:, None].copy()
            n_valid = None
            consumed = np.ones(self.max_slots, np.int32)
        nxt, finite, logits = self._forward(tokens, n_valid, temps,
                                            want_logits)
        lanes = []
        for s in active:
            c = int(consumed[s])
            p_before = int(self.slot_pos[s])
            self.slot_pos[s] += c
            lanes.append(_Lane(slot=s, req=self.slot_req[s], consumed=c,
                               p_before=p_before,
                               p_after=int(self.slot_pos[s])))
        self.steps += 1
        return nxt, finite, logits, lanes

    def _commit(self, nxt: torch.Tensor, finite: torch.Tensor,
                logits: Optional[torch.Tensor], lanes: List[_Lane]) -> None:
        """Bring the step's tokens to the host (the device wait) and commit
        them: prompt logits, first/next tokens, terminations."""
        nxt = nxt.cpu().numpy()
        bad = ~finite.cpu().numpy()
        logits = None if logits is None else logits.float().cpu().numpy()
        for ln in lanes:
            s, req = ln.slot, ln.req
            if bad[s]:
                self._vacate(s)
                self._terminate(req, RequestStatus.FAILED, 'nonfinite_logits')
                continue
            stream = self.slot_stream[s]
            if req.return_logits and ln.p_before < len(stream):
                # lanes 0..consumed-1 hold logits for stream[p_before:p_after]
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
            req.generated.append(tok)
            self.slot_next_tok[s] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if hit_eos or len(req.generated) >= req.max_new_tokens \
                    or ln.p_after + 1 >= self.max_seq:
                self._vacate(s)
                self._terminate(req, RequestStatus.FINISHED)

    def run(self, max_iters: int = 100_000) -> Dict[str, float]:
        """Drive the engine until all submitted work is terminal or
        ``max_iters`` steps elapse; still-queued work is then marked
        ``FAILED('stalled')``. Returns a report with latency percentiles
        (keys omitted until a request finished)."""
        it = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and it < max_iters:
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
               'failed': self.n_failed,
               'deadline_exceeded': self.n_deadline}
        if self._lat_hist.count:
            out['p50_latency_s'] = self._lat_hist.percentile(50)
            out['p99_latency_s'] = self._lat_hist.percentile(99)
        if self._ttft_hist.count:
            out['p50_ttft_s'] = self._ttft_hist.percentile(50)
            out['p99_ttft_s'] = self._ttft_hist.percentile(99)
        return out

    def score(self, prompts: List[np.ndarray]) -> List[np.ndarray]:
        """All-position logits of each prompt: ``out[i][t]`` is the
        next-token distribution after ``prompts[i][t]``. Raises
        :class:`ScoringError` if any prompt ends without its logits."""
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

    def stats(self, requests: List[Request]) -> Dict[str, float]:
        """Aggregate statistics over ``requests`` plus engine counters;
        latency/TTFT keys are omitted when they have no samples."""
        done = [r for r in requests if r.done]
        lat = [r.finish_t - r.submit_t for r in done]
        ttft = [r.first_token_t - r.submit_t for r in done if r.first_token_t]
        out = {
            'completed': len(done),
            'tokens': sum(len(r.generated) for r in done),
            'engine_steps': self.steps,
            'lanes_dispatched': self.lanes_dispatched,
            'lane_tokens': self.lane_tokens,
            'prefill_lane_utilization':
                self.lane_tokens / self.lanes_dispatched
                if self.lanes_dispatched else 0.0,
            'failed': self.n_failed,
            'deadline_exceeded': self.n_deadline,
            'stalled': self.n_stalled,
        }
        out.update(latency_summary('latency_s', lat))
        out.update(latency_summary('ttft_s', ttft))
        return out
