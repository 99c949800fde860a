"""MetricsRegistry: counters, gauges, fixed-bucket histograms.

Design constraints, in order:

1. **Hot-path cost.** The fused dispatch path records a handful of
   metrics per BATCH (not per request). Components look instruments up
   ONCE at construction (``self._m_requests = registry.counter(...)``)
   and the record call is a plain attribute bump — no dict lookup, no
   label hashing per record. The :class:`NullMetricsRegistry` hands
   every lookup the same shared no-op instrument, so the disabled
   plane costs one no-op method call per record site (gated within 5%
   of obs-off in the reference's ``routing_fastpath_bench``).
2. **Determinism.** ``collect()`` orders samples by (name, sorted
   labels); histogram buckets are fixed at creation. Two identical
   runs export byte-identical Prometheus text.
3. **Serialization.** ``state_dict()`` is pure JSON (label maps via
   :mod:`repro_torch.obs.keys`); metric values ride the snapshot envelope's
   state half. Restoring is ``load_state_dict`` — instruments already
   handed out stay LIVE (the registry updates them in place rather
   than replacing them), so components keep their cached handles
   across a restore.
"""

from __future__ import annotations

import bisect
from typing import Iterator, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "NullInstrument", "NULL_INSTRUMENT",
    "MetricsRegistry", "NullMetricsRegistry", "DEFAULT_TIME_BUCKETS",
]

#: Default latency buckets (seconds) — spans micro-benchmark kernel
#: calls (~50us interpret) through engine-step walls (~seconds).
DEFAULT_TIME_BUCKETS = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """Monotone counter (ints or dollars). ``value`` is directly
    assignable — restore/resync paths set it from serialized state."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (queue depth, $/query EWMA, pressure)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram. ``buckets`` are upper bounds (le);
    observations above the last bound land in the +Inf bucket."""

    __slots__ = ("buckets", "counts", "total", "n")
    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"histogram buckets must be strictly "
                             f"increasing, got {buckets}")
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self.total = 0.0
        self.n = 0

    def observe(self, v) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.total += v
        self.n += 1


class NullInstrument:
    """The disabled plane's instrument: every record is a no-op. One
    shared instance backs every lookup on a NullMetricsRegistry."""

    __slots__ = ()
    kind = "null"

    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass


NULL_INSTRUMENT = NullInstrument()


def _label_key(labels: Mapping[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create instrument store keyed by (name, labels)."""

    enabled = True

    def __init__(self) -> None:
        self._metrics: dict[Tuple[str, LabelKey], object] = {}

    # -- instrument lookup (construction-time, not hot path) ------------------

    def _get(self, name: str, labels: Mapping[str, str], cls, *args):
        key = (str(name), _label_key(labels))
        inst = self._metrics.get(key)
        if inst is None:
            inst = cls(*args)
            self._metrics[key] = inst
        elif not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r}{dict(labels)} already registered as "
                f"{inst.kind}, requested {cls.kind}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  **labels) -> Histogram:
        h = self._get(name, labels, Histogram, buckets)
        if h.buckets != tuple(float(b) for b in buckets):
            raise ValueError(f"histogram {name!r}{dict(labels)} already "
                             f"registered with buckets {h.buckets}")
        return h

    # -- reading --------------------------------------------------------------

    def collect(self) -> Iterator[Tuple[str, dict, object]]:
        """(name, labels, instrument) sorted by (name, labels) — the
        deterministic export order."""
        for (name, lkey) in sorted(self._metrics):
            yield name, dict(lkey), self._metrics[(name, lkey)]

    def value(self, name: str, **labels):
        """Convenience read for tests/views; None when absent."""
        inst = self._metrics.get((str(name), _label_key(labels)))
        if inst is None:
            return None
        return inst.value if not isinstance(inst, Histogram) else inst.n

    # -- serialization (pure JSON) --------------------------------------------

    def state_dict(self) -> dict:
        samples = []
        for name, labels, inst in self.collect():
            rec = {"name": name, "labels": labels, "kind": inst.kind}
            if isinstance(inst, Histogram):
                rec.update(buckets=list(inst.buckets),
                           counts=list(inst.counts),
                           total=inst.total, n=inst.n)
            else:
                rec["value"] = inst.value
            samples.append(rec)
        return {"samples": samples}

    def load_state_dict(self, state: Optional[Mapping]) -> None:
        """Restore values IN PLACE: instruments already handed out to
        components keep recording into the restored totals; metrics
        present here but absent from ``state`` reset to zero."""
        samples = (state or {}).get("samples", ())
        seen = set()
        for rec in samples:
            name, labels, kind = rec["name"], rec.get("labels", {}), rec["kind"]
            if kind == "counter":
                inst = self.counter(name, **labels)
                inst.value = rec["value"]
            elif kind == "gauge":
                inst = self.gauge(name, **labels)
                inst.value = rec["value"]
            elif kind == "histogram":
                inst = self.histogram(name, buckets=rec["buckets"], **labels)
                inst.counts = [int(c) for c in rec["counts"]]
                inst.total = float(rec["total"])
                inst.n = int(rec["n"])
            else:
                raise ValueError(f"unknown metric kind {kind!r} in state")
            seen.add((str(name), _label_key(labels)))
        for key, inst in self._metrics.items():
            if key in seen:
                continue
            if isinstance(inst, Histogram):
                inst.counts = [0] * (len(inst.buckets) + 1)
                inst.total, inst.n = 0.0, 0
            else:
                inst.value = 0 if isinstance(inst, Counter) else 0.0


class NullMetricsRegistry(MetricsRegistry):
    """Disabled plane: every lookup returns the shared no-op
    instrument; state is empty; loads are ignored."""

    enabled = False

    def counter(self, name: str, **labels) -> NullInstrument:
        return NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> NullInstrument:
        return NULL_INSTRUMENT

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  **labels) -> NullInstrument:
        return NULL_INSTRUMENT

    def collect(self):
        return iter(())

    def state_dict(self) -> dict:
        return {"samples": []}

    def load_state_dict(self, state: Optional[Mapping]) -> None:
        pass
