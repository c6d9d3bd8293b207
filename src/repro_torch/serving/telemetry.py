"""Serving telemetry: a metrics registry plus a per-request span tracer —
a copy of ``repro/serving/telemetry.py``. The port keeps its own copy
because ``repro/serving/__init__.py`` imports the JAX engine.

- :class:`MetricsRegistry` — named **counters**, **gauges** (optionally
  callback-backed, sampled at export time) and fixed-bucket
  :class:`Histogram` s with p50/p90/p99, all label-addressable
  (``registry.histogram('engine.step.phase_s', phase='dispatch',
  backend='cuda', kind='prefill')``).
- :class:`SpanTracer` — per-request lifecycle events with monotonic
  stamps: submit, admission (with prefix-hit length), each prefill-chunk
  dispatch, first token, every decode step, preemption/resume, COW
  copies, evictions, fault injections, and the terminal status. The
  ``uid=None`` stream holds engine-global events (evictions, injected
  faults) so a chaos run is replayable from the trace alone.
- :class:`Telemetry` — the facade the engine holds. Three export
  formats: :meth:`Telemetry.snapshot` (structured dict → JSON),
  :meth:`Telemetry.prometheus_text` (Prometheus exposition text), and
  :meth:`Telemetry.chrome_trace` (Chrome ``chrome://tracing`` / Perfetto
  JSON of the request spans).

**Zero-cost when disabled.** The engine holds :data:`NULL_TELEMETRY` (a
:class:`NullTelemetry` singleton, ``enabled = False``) unless telemetry
was requested, and every instrumentation site is guarded by a plain
``if tel.enabled:`` — a disabled engine performs no recorder calls, no
dict/list allocation, and no clock reads per step. Enabled telemetry
reads the host's clock only: no ``.cpu()``, ``.item()`` or
``torch.cuda.synchronize()``. On a CUDA device the ``dispatch`` phase is
therefore the host's cost of enqueueing the step's kernels, and the
device wait lands in ``sample_commit``, at the ``.cpu()`` of the sampled
tokens that the engine performs anyway. Telemetry-on tokens are bitwise
telemetry-off tokens (``tests/test_torch_telemetry.py``).

Metric and trace-event **names are defined here, once** (the ``KV_*``,
``STEP_*``, ``REQUEST_*`` and ``EV_*`` constants below), with the JAX
package's strings, so the two packages' exports read alike. The
``backend`` label of the phase series is the port's backend name
(``reference`` or ``cuda``).
"""
from __future__ import annotations

import json
import time
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Tuple

# --------------------------------------------------------------------------
# Metric names — the single source of truth. kvpool.stats() builds its dict
# from the KV_* constants and launch/serve.py indexes with them, so a key
# exists in exactly one place.
KV_PREFIX_HITS = 'prefix_hits'
KV_PREFIX_MISSES = 'prefix_misses'
KV_PREFIX_HIT_RATE = 'prefix_hit_rate'
KV_PREFIX_HIT_TOKENS = 'prefix_hit_tokens'
KV_PAGES_IN_USE = 'pages_in_use'
KV_PAGES_FREE = 'pages_free'
KV_PAGES_RECLAIMABLE = 'pages_reclaimable'
KV_EVICTIONS = 'evictions'
KV_COW_COPIES = 'cow_copies'

# engine.step.phase_s{phase=,backend=,kind=} — per-step phase latency.
STEP_PHASE = 'engine.step.phase_s'
# The phase taxonomy (the engine's module docstring has the details):
#   host_schedule — fault hooks, deadlines, admission, victim selection,
#                   lane building (radix time subtracted out)
#   radix_lookup  — prefix-cache match during this step's admissions
#   pack_layout   — host->device argument assembly (temps, positions,
#                   tokens, page tables, job lists)
#   dispatch      — the forward call: on a CUDA device the host's cost of
#                   enqueueing its kernels (asynchronous; NOT device time)
#   sample_commit — host transfer of sampled tokens (absorbs the device
#                   wait) + per-slot commit bookkeeping
PHASES = ('host_schedule', 'radix_lookup', 'pack_layout', 'dispatch',
          'sample_commit')
STEP_KINDS = ('prefill', 'decode', 'mixed')

# engine.step.overlap_s{backend=} — host-side scheduling work (the
# host_schedule + radix_lookup + pack_layout phases of step N+1) performed
# while step N's device dispatch is still in flight, i.e. before its
# sample_commit transfer. Observed only by an async double-buffered loop;
# the port's synchronous loop never emits it. overlap fraction =
# sum(overlap_s) / sum(those three phases).
STEP_OVERLAP = 'engine.step.overlap_s'
# engine.queue.depth — callback gauge: requests waiting for a slot right
# now (admission queue length, excluding requests already in flight).
QUEUE_DEPTH = 'engine.queue.depth'

REQUEST_LATENCY = 'request.latency_s'     # submit -> finish, FINISHED only
REQUEST_TTFT = 'request.ttft_s'           # submit -> first sampled token

# Trace event names (SpanTracer). Terminal events end a request's span.
EV_SUBMIT = 'SUBMIT'
EV_ADMIT = 'ADMIT'                 # first admission to a slot
EV_RESUME = 'RESUME'               # re-admission after a PREEMPT
EV_PREFILL_CHUNK = 'PREFILL_CHUNK'
EV_FIRST_TOKEN = 'FIRST_TOKEN'
EV_DECODE_STEP = 'DECODE_STEP'
EV_PREEMPT = 'PREEMPT'
EV_COW = 'COW'
EV_EVICT = 'EVICT'                 # engine-global (uid None)
EV_FINISH = 'FINISH'
EV_FAIL = 'FAIL'
EV_CANCEL = 'CANCEL'
EV_FAULT_STEAL = 'FAULT_STEAL_PAGES'       # engine-global fault injections
EV_FAULT_RESTORE = 'FAULT_RESTORE_PAGES'
EV_FAULT_CANCEL = 'FAULT_CANCEL'
EV_FAULT_POISON = 'FAULT_POISON_LANES'

TERMINAL_EVENTS = frozenset({EV_FINISH, EV_FAIL, EV_CANCEL})


def _geometric_bounds(lo: float = 1e-6, hi: float = 64.0,
                      ratio: float = 2 ** 0.5) -> Tuple[float, ...]:
    bounds: List[float] = []
    v = lo
    while v < hi * (1.0 + 1e-9):
        bounds.append(v)
        v *= ratio
    return tuple(bounds)


# 1 µs .. 64 s at a sqrt(2) ratio: covers both per-phase step times and
# whole-request latencies with <= ~41% within-bucket resolution, which the
# min/max-clamped interpolation in Histogram.percentile tightens further.
DEFAULT_BOUNDS = _geometric_bounds()


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``bounds`` are the buckets' inclusive upper edges (plus an implicit
    +Inf overflow bucket). Percentiles interpolate linearly inside the
    selected bucket and clamp to the observed min/max, so a single-valued
    histogram reports that value exactly and estimation error is bounded
    by one bucket's width.
    """
    __slots__ = ('bounds', 'counts', 'count', 'total', '_min', '_max')

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BOUNDS):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.total = 0.0
        self._min = float('inf')
        self._max = float('-inf')

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> Optional[float]:
        """Interpolated q-th percentile (q in [0, 100]); None when empty."""
        if not self.count:
            return None
        target = (q / 100.0) * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c:
                lo = self.bounds[i - 1] if i > 0 else self._min
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                lo = max(min(lo, hi), self._min)
                hi = min(hi, self._max)
                est = lo + (hi - lo) * max(0.0, min(1.0, (target - cum) / c))
                return float(min(max(est, self._min), self._max))
            cum += c
        return float(self._max)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            'count': self.count, 'sum': self.total, 'mean': self.mean,
        }
        if self.count:
            out.update(min=self._min, max=self._max,
                       p50=self.percentile(50), p90=self.percentile(90),
                       p99=self.percentile(99))
            out['buckets'] = [
                [self.bounds[i] if i < len(self.bounds) else float('inf'), c]
                for i, c in enumerate(self.counts) if c]
        return out

    @classmethod
    def of(cls, values) -> 'Histogram':
        h = cls()
        for v in values:
            h.observe(v)
        return h


class Counter:
    __slots__ = ('value',)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value: either set explicitly or backed by a callback
    sampled at export time (``fn``) — the pool-occupancy pattern."""
    __slots__ = ('_value', 'fn')

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._value = 0.0
        self.fn = fn

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return float(self.fn()) if self.fn is not None else self._value


_Labels = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _Labels:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _series_name(name: str, labels: _Labels) -> str:
    if not labels:
        return name
    return name + '{' + ','.join(f'{k}={v}' for k, v in labels) + '}'


def _prom_name(name: str) -> str:
    return name.replace('.', '_').replace('-', '_')


class MetricsRegistry:
    """Label-addressable counters, gauges and histograms. Lookups create
    on first use and return the same object thereafter, so hot paths can
    pre-resolve their series once and skip the dict hop per event."""

    def __init__(self):
        self._counters: Dict[Tuple[str, _Labels], Counter] = {}
        self._gauges: Dict[Tuple[str, _Labels], Gauge] = {}
        self._hists: Dict[Tuple[str, _Labels], Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              **labels) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge(fn)
        elif fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str,
                  bounds: Tuple[float, ...] = DEFAULT_BOUNDS,
                  **labels) -> Histogram:
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram(bounds)
        return h

    def find(self, name: str) -> Dict[_Labels, Any]:
        """Every series registered under ``name``, keyed by its labels."""
        out: Dict[_Labels, Any] = {}
        for store in (self._counters, self._gauges, self._hists):
            for (n, labels), metric in store.items():
                if n == name:
                    out[labels] = metric
        return out

    def snapshot(self) -> Dict[str, Any]:
        return {
            'counters': {_series_name(n, lb): c.value
                         for (n, lb), c in sorted(self._counters.items())},
            'gauges': {_series_name(n, lb): g.value
                       for (n, lb), g in sorted(self._gauges.items())},
            'histograms': {_series_name(n, lb): h.snapshot()
                           for (n, lb), h in sorted(self._hists.items())},
        }

    def prometheus_text(self) -> str:
        """Prometheus exposition format. Dotted metric names sanitize to
        underscores; histograms emit the standard cumulative ``_bucket``
        (le-labelled) / ``_sum`` / ``_count`` triplet."""
        lines: List[str] = []

        def fmt_labels(labels: _Labels, extra: str = '') -> str:
            parts = [f'{k}="{v}"' for k, v in labels]
            if extra:
                parts.append(extra)
            return '{' + ','.join(parts) + '}' if parts else ''

        for (name, labels), c in sorted(self._counters.items()):
            pn = _prom_name(name)
            lines.append(f'# TYPE {pn} counter')
            lines.append(f'{pn}{fmt_labels(labels)} {c.value}')
        for (name, labels), g in sorted(self._gauges.items()):
            pn = _prom_name(name)
            lines.append(f'# TYPE {pn} gauge')
            lines.append(f'{pn}{fmt_labels(labels)} {g.value}')
        for (name, labels), h in sorted(self._hists.items()):
            pn = _prom_name(name)
            lines.append(f'# TYPE {pn} histogram')
            cum = 0
            for i, c in enumerate(h.counts):
                cum += c
                le = (f'{h.bounds[i]:.9g}' if i < len(h.bounds) else '+Inf')
                le_label = 'le="%s"' % le
                lines.append(
                    f'{pn}_bucket{fmt_labels(labels, le_label)} {cum}')
            lines.append(f'{pn}_sum{fmt_labels(labels)} {h.total:.9g}')
            lines.append(f'{pn}_count{fmt_labels(labels)} {h.count}')
        return '\n'.join(lines) + '\n'


class SpanTracer:
    """Per-request event streams with monotonic stamps. ``uid=None`` is
    the engine-global stream (evictions, fault injections)."""

    def __init__(self):
        self.spans: Dict[Optional[int], List[Tuple[float, str,
                                                   Optional[dict]]]] = {}

    def event(self, uid: Optional[int], name: str,
              t: Optional[float] = None, **attrs) -> None:
        if t is None:
            t = time.monotonic()
        self.spans.setdefault(uid, []).append((t, name, attrs or None))

    def events(self, uid: Optional[int]) -> List[Tuple[float, str,
                                                       Optional[dict]]]:
        return self.spans.get(uid, [])

    def names(self, uid: Optional[int]) -> List[str]:
        return [name for _, name, _ in self.events(uid)]

    @property
    def n_events(self) -> int:
        return sum(len(v) for v in self.spans.values())


class Telemetry:
    """Enabled recorder: a registry + a tracer + the export formats."""

    enabled = True
    now = staticmethod(time.monotonic)   # same clock as Request stamps

    def __init__(self):
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer()

    def event(self, uid: Optional[int], name: str,
              t: Optional[float] = None, **attrs) -> None:
        self.tracer.event(uid, name, t=t, **attrs)

    # ------------------------------------------------------------- exports
    def snapshot(self) -> Dict[str, Any]:
        return {
            'enabled': True,
            'metrics': self.registry.snapshot(),
            'trace': {'n_spans': len(self.tracer.spans),
                      'n_events': self.tracer.n_events},
        }

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    def chrome_trace(self) -> Dict[str, Any]:
        """Request spans as Chrome trace-event JSON (``chrome://tracing``
        or https://ui.perfetto.dev): one thread per request (named
        ``request <uid>``), tid 0 for the engine-global stream. Lifecycle
        events appear as instants; `queued` / `running` slices are
        synthesized between SUBMIT/ADMIT/RESUME/PREEMPT/terminal
        boundaries. Timestamps are monotonic-clock microseconds."""
        events: List[Dict[str, Any]] = [
            {'ph': 'M', 'name': 'process_name', 'pid': 1,
             'args': {'name': 'serving-engine'}},
            {'ph': 'M', 'name': 'thread_name', 'pid': 1, 'tid': 0,
             'args': {'name': 'engine'}},
        ]

        def first_t(item):
            uid, evs = item
            return evs[0][0] if evs else 0.0

        uids = [u for u in self.spans_in_order() if u is not None]
        tid_of = {u: i + 1 for i, u in enumerate(uids)}
        for uid, span in sorted(self.tracer.spans.items(),
                                key=first_t):
            tid = 0 if uid is None else tid_of[uid]
            if uid is not None:
                events.append({'ph': 'M', 'name': 'thread_name', 'pid': 1,
                               'tid': tid,
                               'args': {'name': f'request {uid}'}})
            open_name: Optional[str] = None
            open_t = 0.0
            for t, name, attrs in span:
                ts = t * 1e6
                args = dict(attrs) if attrs else {}
                args['uid'] = uid
                events.append({'ph': 'i', 's': 't', 'name': name, 'ts': ts,
                               'pid': 1, 'tid': tid, 'args': args})
                if uid is None:
                    continue
                # synthesized slices: queued (SUBMIT->admit) and running
                # (admit->preempt/terminal); a PREEMPT re-opens queued
                boundary = (name in (EV_SUBMIT, EV_ADMIT, EV_RESUME,
                                     EV_PREEMPT)
                            or name in TERMINAL_EVENTS)
                if not boundary:
                    continue
                if open_name is not None:
                    events.append({'ph': 'X', 'name': open_name,
                                   'ts': open_t * 1e6,
                                   'dur': max(ts - open_t * 1e6, 0.0),
                                   'pid': 1, 'tid': tid,
                                   'args': {'uid': uid}})
                    open_name = None
                if name == EV_SUBMIT or name == EV_PREEMPT:
                    open_name, open_t = 'queued', t
                elif name in (EV_ADMIT, EV_RESUME):
                    open_name, open_t = 'running', t
        return {'traceEvents': events, 'displayTimeUnit': 'ms'}

    def spans_in_order(self) -> List[Optional[int]]:
        """Span uids ordered by first event time (stable tid assignment)."""
        return [uid for uid, evs in
                sorted(self.tracer.spans.items(),
                       key=lambda kv: kv[1][0][0] if kv[1] else 0.0)]

    # --------------------------------------------------------------- files
    def write_json(self, path: str) -> None:
        with open(path, 'w') as f:
            json.dump(self.snapshot(), f, indent=2)

    def write_prometheus(self, path: str) -> None:
        with open(path, 'w') as f:
            f.write(self.prometheus_text())

    def write_chrome_trace(self, path: str) -> None:
        with open(path, 'w') as f:
            json.dump(self.chrome_trace(), f)


class NullTelemetry:
    """The disabled recorder: ``enabled`` is False and every engine
    instrumentation site is guarded on it, so no method here runs on the
    hot path at all — this class exists so ``engine.telemetry.event(...)``
    is still safe to call unguarded from cold paths, and so the disabled
    engine holds one shared singleton (:data:`NULL_TELEMETRY`) instead of
    allocating anything per engine."""

    enabled = False
    now = staticmethod(time.monotonic)
    registry = None
    tracer = None

    def event(self, uid, name, t=None, **attrs) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {'enabled': False}

    def prometheus_text(self) -> str:
        return ''

    def chrome_trace(self) -> Dict[str, Any]:
        return {'traceEvents': [], 'displayTimeUnit': 'ms'}


NULL_TELEMETRY = NullTelemetry()


def coerce(telemetry) -> 'Telemetry | NullTelemetry':
    """Engine-constructor convenience: False/None -> the shared no-op
    singleton, True -> a fresh :class:`Telemetry`, an existing recorder
    (anything with an ``enabled`` attribute) passes through."""
    if telemetry is None or telemetry is False:
        return NULL_TELEMETRY
    if telemetry is True:
        return Telemetry()
    if not hasattr(telemetry, 'enabled'):
        raise TypeError(f'not a telemetry recorder: {telemetry!r}')
    return telemetry


def latency_summary(suffix: str, values) -> Dict[str, float]:
    """``mean_/p50_/p99_<suffix>`` keys for a sample list — and NO keys at
    all when the sample set is empty, so an absent measurement can never
    masquerade as a genuine 0.0 (callers print ``n/a``). Percentiles come
    from the fixed-bucket :class:`Histogram`, the same estimator the
    registry exports."""
    if not len(values):
        return {}
    h = Histogram.of(values)
    return {
        f'mean_{suffix}': h.mean,
        f'p50_{suffix}': h.percentile(50),
        f'p99_{suffix}': h.percentile(99),
    }
