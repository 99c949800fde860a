"""Clocks for the observability plane.

Everything in `repro_torch.obs` that timestamps (span start/end, event
times, wall timings) reads time through a ``Clock`` so golden tests
can pin it: :class:`MonotonicClock` is ``time.perf_counter`` for real
measurement, :class:`ManualClock` advances a fixed step per read so
two identical runs produce byte-identical JSONL exports.
"""

from __future__ import annotations

import time

__all__ = ["Clock", "MonotonicClock", "ManualClock", "NullClock"]


class Clock:
    """Protocol: ``now() -> float`` seconds, monotone non-decreasing."""

    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class MonotonicClock(Clock):
    """Real wall time (``time.perf_counter``)."""

    def now(self) -> float:
        return time.perf_counter()


class ManualClock(Clock):
    """Deterministic clock for golden tests: starts at ``start`` and
    advances exactly ``step`` seconds every ``now()`` read (step=0
    freezes it). ``advance()`` jumps it explicitly."""

    def __init__(self, start: float = 0.0, step: float = 0.001):
        self.t = float(start)
        self.step = float(step)

    def now(self) -> float:
        t = self.t
        self.t += self.step
        return t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class NullClock(Clock):
    """The disabled plane's clock: constant 0.0, no syscall."""

    def now(self) -> float:
        return 0.0
