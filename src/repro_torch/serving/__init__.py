"""Serving: the continuous-batching engine, sampler, paged pool, fault
injection and telemetry."""
from repro_torch.serving.engine import (Request, RequestStatus, ScoringError,
                                        ServingEngine)
from repro_torch.serving.faults import FaultInjector, ScriptedFaults
from repro_torch.serving.kvpool import PrefixCache
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.telemetry import (NULL_TELEMETRY, Histogram,
                                           MetricsRegistry, SpanTracer,
                                           Telemetry)

__all__ = ['Request', 'RequestStatus', 'ScoringError', 'ServingEngine',
           'PrefixCache', 'FaultInjector', 'ScriptedFaults', 'sample_tokens',
           'Telemetry', 'NULL_TELEMETRY', 'Histogram', 'MetricsRegistry',
           'SpanTracer']
