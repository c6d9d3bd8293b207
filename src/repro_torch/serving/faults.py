"""Deterministic fault injection for chaos-testing the serving engine — a
copy of ``repro/serving/faults.py``, so that one script faults the port's
engine and the JAX package's at the same ticks and steps.

The engine's fault-tolerance contract (see ``repro_torch.serving.engine``) is
only worth anything if its failure paths actually run, on demand, in CI.
This module is the harness: a :class:`FaultInjector` passed as
``ServingEngine(fault_injector=...)`` gets two hooks —

- ``before_step(engine)`` runs at the very top of every
  ``ServingEngine.step_once`` (before deadline checks and admission).
  Mutate the engine here: steal pages from the KV pool to force
  exhaustion-driven preemption, cancel live uids mid-prefill, etc.
- ``poison_lanes(engine, step_idx)`` returns slot indices whose sampled
  logits the NaN/Inf watchdog must treat as non-finite for the dispatch
  that ran at engine step ``step_idx`` — a deterministic stand-in for a
  numerically-exploding lane that fails *only* that request.

:class:`ScriptedFaults` is the concrete, step-indexed implementation used
by ``tests/test_torch_faults.py`` and ``chip_smoke.py``'s chaos run. Pool
steals, restores, and cancels key on ``engine.ticks`` — the number of
``step_once`` entries, which advances even while the engine is starved and
dispatching nothing (``engine.steps`` freezes then, and a restore keyed on
it could never fire). Lane poisoning keys on ``engine.steps`` because a
poisoned dispatch *is* a dispatch. Both counters are deterministic for a
fixed engine configuration and workload, so scripts replay identically.

Every scripted injection also lands in the engine's telemetry trace (uid
``None`` — engine-scope events ``FAULT_STEAL_PAGES`` /
``FAULT_RESTORE_PAGES`` / ``FAULT_CANCEL`` / ``FAULT_POISON_LANES``) when
telemetry is enabled, so a chaos run is replayable from its trace alone.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

from repro_torch.serving import telemetry as TM


class FaultInjector:
    """Base class: no-op hooks. Subclass (or use :class:`ScriptedFaults`)
    and override what you need; the engine calls both hooks every step."""

    def before_step(self, engine) -> None:
        """Mutate the engine/pool before scheduling one step."""

    def poison_lanes(self, engine, step_idx: int) -> Sequence[int]:
        """Slot ids whose logits the watchdog should treat as non-finite
        for the dispatch at ``step_idx``."""
        return ()


class ScriptedFaults(FaultInjector):
    """A step-indexed script of deterministic faults.

    Parameters (all optional; the first three key on ``engine.ticks``,
    ``nan_lanes`` on ``engine.steps`` — see the module docstring):

    - ``steal_pages``: ``{tick: n}`` — grab ``n`` pages straight from the
      KV pool before that tick is scheduled (holding them hostage forces
      ``_ensure_blocks`` / admission exhaustion, i.e. real preemption on
      the real allocation path). If fewer than ``n`` pages can be taken,
      takes as many as possible.
    - ``restore_pages_at``: iterable of ticks at which ALL currently
      stolen pages return to the pool.
    - ``nan_lanes``: ``{step: [slot, ...]}`` — lanes whose logits the
      watchdog treats as non-finite for that dispatch step.
    - ``cancel_uids``: ``{tick: [uid, ...]}`` — mid-flight cancels issued
      before that tick (queued or in-slot, prefill or decode).

    Each scripted fault fires exactly once (entries are popped as they
    trigger).
    """

    def __init__(self, *, steal_pages: Dict[int, int] = None,
                 restore_pages_at: Iterable[int] = (),
                 nan_lanes: Dict[int, Sequence[int]] = None,
                 cancel_uids: Dict[int, Sequence[int]] = None):
        self.steal_pages = dict(steal_pages or {})
        self.restore_pages_at = set(restore_pages_at)
        self.nan_lanes = {k: list(v) for k, v in (nan_lanes or {}).items()}
        self.cancel_uids = {k: list(v)
                            for k, v in (cancel_uids or {}).items()}
        self.stolen: List[int] = []

    def before_step(self, engine) -> None:
        tel = engine.telemetry
        tick = engine.ticks
        if tick in self.restore_pages_at:
            self.restore_pages_at.discard(tick)
            n_back = len(self.stolen)
            self.release_stolen(engine)
            if tel.enabled and n_back:
                tel.event(None, TM.EV_FAULT_RESTORE, tick=tick, pages=n_back)
        n = self.steal_pages.pop(tick, 0)
        if n and engine.kv is not None:
            got = engine.kv.alloc(n)
            while got is None and n > 1:        # partial steal is fine
                n -= 1
                got = engine.kv.alloc(n)
            if got:
                self.stolen.extend(got)
                if tel.enabled:
                    tel.event(None, TM.EV_FAULT_STEAL, tick=tick,
                              pages=len(got))
        for uid in self.cancel_uids.pop(tick, ()):
            if tel.enabled:
                tel.event(None, TM.EV_FAULT_CANCEL, tick=tick, req_uid=uid)
            engine.cancel(uid)

    def poison_lanes(self, engine, step_idx: int) -> Sequence[int]:
        lanes = self.nan_lanes.pop(step_idx, ())
        if lanes and engine.telemetry.enabled:
            engine.telemetry.event(None, TM.EV_FAULT_POISON, step=step_idx,
                                   lanes=list(lanes))
        return lanes

    def release_stolen(self, engine) -> None:
        """Return every stolen page to the pool."""
        if self.stolen and engine.kv is not None:
            engine.kv.free(self.stolen)
            self.stolen = []
