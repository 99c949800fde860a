"""`repro_torch.obs` — the unified observability plane.

One :class:`Observability` object bundles the measurement surfaces the
serving stack threads through every component:

* :class:`~repro_torch.obs.registry.MetricsRegistry` — counters, gauges
  and fixed-bucket histograms. Components cache instrument handles at
  construction; the disabled registry hands out shared no-op
  instruments so the fast path pays one attribute load + one no-op call
  per record.
* :class:`~repro_torch.obs.trace.Tracer` — request-scoped spans + events,
  recorded at BATCH granularity (one event carries the request-id range
  it covers); :func:`~repro_torch.obs.export.request_timelines`
  re-expands them into one ordered per-request timeline.
* exporters — :func:`~repro_torch.obs.export.to_jsonl` event log and
  :func:`~repro_torch.obs.export.prometheus_text` metrics snapshot, both
  byte-deterministic under a :class:`~repro_torch.obs.clock.ManualClock`.

Observability is RUNTIME configuration, like ``runners=``: it is passed
to ``repro_torch.api.build(spec, obs=...)``, never serialized into the
``RouteSpec``. Metric VALUES ride the snapshot envelope's state half
(``state["obs"]``) when enabled; trace event history never serializes.
"""

from repro_torch.obs.clock import Clock, ManualClock, MonotonicClock  # noqa: F401
from repro_torch.obs.keys import int_keyed, str_keyed  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullMetricsRegistry,
)
from repro_torch.obs.trace import NullTracer, Span, Tracer  # noqa: F401
from repro_torch.obs.plane import NULL_OBS, Observability  # noqa: F401
from repro_torch.obs.export import (  # noqa: F401
    prometheus_text,
    request_timelines,
    span_tree,
    to_jsonl,
)

__all__ = [
    "Observability", "NULL_OBS",
    "MetricsRegistry", "NullMetricsRegistry",
    "Counter", "Gauge", "Histogram", "DEFAULT_TIME_BUCKETS",
    "Tracer", "NullTracer", "Span",
    "Clock", "ManualClock", "MonotonicClock",
    "to_jsonl", "prometheus_text", "request_timelines", "span_tree",
    "str_keyed", "int_keyed",
]
