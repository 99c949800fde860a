"""The `Observability` facade: one object bundling clock + metrics +
tracer, threaded through the serving stack as RUNTIME configuration
(never serialized into a RouteSpec).

``NULL_OBS`` is the disabled plane every component defaults to: its
registry hands out shared no-op instruments, its tracer no-op spans,
its clock a constant — the fast path's per-batch overhead is a few
no-op calls (bench-gated within 5% at B=1024/K=100).
"""

from __future__ import annotations

import io
from typing import Mapping, Optional

from repro_torch.obs.clock import Clock, MonotonicClock, NullClock
from repro_torch.obs.export import prometheus_text, to_jsonl
from repro_torch.obs.registry import MetricsRegistry, NullMetricsRegistry
from repro_torch.obs.trace import DEFAULT_MAX_EVENTS, NullTracer, Tracer

__all__ = ["Observability", "NULL_OBS"]


class Observability:
    """clock + MetricsRegistry + Tracer, with exporter conveniences."""

    enabled = True

    def __init__(self, clock: Optional[Clock] = None,
                 max_events: int = DEFAULT_MAX_EVENTS):
        self.clock = clock or MonotonicClock()
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(self.clock, max_events=max_events)

    # -- exporters ------------------------------------------------------------

    def jsonl(self) -> str:
        """The trace event log as JSONL text (one event per line,
        byte-deterministic under a ManualClock)."""
        return to_jsonl(self.tracer.events())

    def export_jsonl(self, path) -> int:
        """Write the event log to ``path``; returns the line count."""
        events = self.tracer.events()
        text = to_jsonl(events)
        if isinstance(path, io.IOBase):
            path.write(text + ("\n" if text else ""))
        else:
            with open(path, "w") as fh:
                fh.write(text + ("\n" if text else ""))
        return len(events)

    def prometheus(self) -> str:
        """Prometheus text-format snapshot of the metrics registry."""
        return prometheus_text(self.metrics)

    # -- serialization (metrics only; see api/session.py) ---------------------

    def state_dict(self) -> dict:
        """Metric values only. Trace events are local measurement
        history and deliberately do NOT ride snapshots (a restored
        replica starts a fresh timeline; counters/histograms carry
        the cumulative story)."""
        return self.metrics.state_dict()

    def load_state_dict(self, state: Optional[Mapping]) -> None:
        self.metrics.load_state_dict(state)

    def telemetry(self) -> dict:
        return {
            "enabled": self.enabled,
            "n_events": len(self.tracer),
            "n_dropped": self.tracer.n_dropped,
            "n_metrics": sum(1 for _ in self.metrics.collect()),
        }


class _NullObservability(Observability):
    """Disabled plane. Singleton (``NULL_OBS``); constructing more is
    harmless but pointless."""

    enabled = False

    def __init__(self):
        self.clock = NullClock()
        self.metrics = NullMetricsRegistry()
        self.tracer = NullTracer()

    def telemetry(self) -> dict:
        return {"enabled": False}


NULL_OBS = _NullObservability()
