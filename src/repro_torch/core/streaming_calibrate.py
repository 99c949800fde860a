"""Streaming, drift-aware threshold calibration (training-free, online).

``core.calibrate`` fits thresholds from a static unlabeled sample; serving
needs the inverse problem solved CONTINUOUSLY: live traffic drifts away
from the calibration distribution (RAGRouter and cost-aware-routing both
document the quality cliff), and the tier mix silently walks off the
budget. Because the SkewRoute router is a pure quantile rule, the fix
stays training-free: keep a sliding window of recent difficulty samples,
watch the OBSERVED tier shares under the current thresholds, and when
they drift past a tolerance re-fit the thresholds from window quantiles
and hot-swap the (frozen, trivially swappable) ``RouterConfig``.

The window is an exact ring buffer — at serving batch sizes the O(W log W)
quantile over a few-thousand-float window is noise next to a single LLM
token, and exactness keeps the convergence guarantee of
``calibrate_threshold`` (same quantile, same data ⇒ same theta).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.router import RouterConfig


class SlidingWindow:
    """Fixed-capacity ring buffer over a scalar stream (float32).

    Keeps the most recent ``capacity`` samples; O(1) amortized pushes,
    exact quantiles over the current contents.
    """

    def __init__(self, capacity: int):
        if capacity < 2:
            raise ValueError(f"window capacity must be >= 2, got {capacity}")
        self.capacity = capacity
        self._buf = np.empty(capacity, np.float32)
        self._n = 0          # total samples ever pushed
        self._head = 0       # next write position

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total_seen(self) -> int:
        return self._n

    def push(self, values: np.ndarray) -> None:
        v = np.asarray(values, np.float32).ravel()
        if v.size >= self.capacity:       # batch alone fills the window
            self._buf[:] = v[-self.capacity:]
            self._head = 0
        else:
            end = self._head + v.size
            if end <= self.capacity:
                self._buf[self._head:end] = v
            else:
                split = self.capacity - self._head
                self._buf[self._head:] = v[:split]
                self._buf[:end - self.capacity] = v[split:]
            self._head = end % self.capacity
        self._n += v.size

    def values(self) -> np.ndarray:
        """Current window contents (order-free copy)."""
        return self._buf[:len(self)].copy()

    def recent(self, n: int) -> np.ndarray:
        """The most recent ``min(n, len(self))`` samples, OLDEST first —
        the chronological tail replica sync publishes as its delta."""
        n = min(int(n), len(self))
        if n <= 0:
            return np.empty(0, np.float32)
        if self._n <= self.capacity and self._head >= len(self):
            # ring has not wrapped: chronological order IS buffer order
            return self._buf[len(self) - n:len(self)].copy()
        # wrapped ring: chronological order is [head:] then [:head]
        chron = np.concatenate([self._buf[self._head:len(self)],
                                self._buf[:self._head]])
        return chron[-n:].copy()

    def quantile(self, q) -> np.ndarray:
        if len(self) == 0:
            raise ValueError("empty window has no quantiles")
        return np.quantile(self._buf[:len(self)], q)

    # -- serializable state (exact: restores the ring bit-for-bit) -----------

    def state_dict(self) -> dict:
        return {"capacity": self.capacity,
                "buffer": [float(x) for x in self._buf[:len(self)]],
                "head": self._head,
                "total_seen": self._n}

    def load_state_dict(self, state: dict) -> None:
        # the ring layout (head/wrap positions) only makes sense at the
        # capacity it was recorded under — cross-capacity restores would
        # corrupt sample order or read uninitialized slots
        if int(state["capacity"]) != self.capacity:
            raise ValueError(
                f"window state mismatch: state from a capacity-"
                f"{int(state['capacity'])} window cannot restore into a "
                f"capacity-{self.capacity} window")
        buf = np.asarray(state["buffer"], np.float32)
        n = int(state["total_seen"])
        if buf.size != min(n, self.capacity):
            raise ValueError(
                f"window state mismatch: {buf.size} samples with "
                f"total_seen={n} (expected {min(n, self.capacity)})")
        self._buf[:buf.size] = buf
        self._head = int(state["head"])
        self._n = n


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One hot-swap: what was observed and what the thresholds became."""

    at_sample: int                       # total_seen when the swap fired
    observed_shares: tuple[float, ...]
    target_shares: tuple[float, ...]
    old_thresholds: tuple[float, ...]
    new_thresholds: tuple[float, ...]

    @property
    def max_drift(self) -> float:
        return max(abs(o - t) for o, t in
                   zip(self.observed_shares, self.target_shares))


class StreamingCalibrator:
    """Sliding-window quantile calibrator with drift-triggered hot-swap.

    Feed per-batch difficulty samples via :meth:`observe`; it returns a
    fresh :class:`RouterConfig` whenever the observed tier shares under
    the CURRENT thresholds drift more than ``tolerance`` (L-inf over
    shares) from ``target_shares`` — and ``None`` otherwise. The caller
    (the dispatcher) owns the swap; the calibrator owns the statistics.

    Knobs:
      window:       samples of history the quantiles see (drift response
                    time ~ window / batch_rate).
      min_samples:  don't judge drift before the window has this much.
      tolerance:    max |observed - target| share before refitting.
      cooldown:     samples to wait after a swap before the next one
                    (prevents threshold flapping while the window still
                    mixes pre- and post-drift traffic).
    """

    def __init__(self, config: RouterConfig,
                 target_shares: Sequence[float],
                 window: int = 4096, min_samples: int = 256,
                 tolerance: float = 0.05,
                 cooldown: Optional[int] = None):
        shares = tuple(float(s) for s in target_shares)
        if len(shares) != config.n_tiers:
            raise ValueError(f"{config.n_tiers} tiers but "
                             f"{len(shares)} target shares")
        if any(s < 0 for s in shares) or abs(sum(shares) - 1.0) > 1e-6:
            raise ValueError(f"target shares must be >= 0 and sum to 1, "
                             f"got {shares}")
        if not 0.0 < tolerance < 1.0:
            raise ValueError(f"tolerance must be in (0,1), got {tolerance}")
        self.config = config
        self.target_shares = shares
        self.tolerance = tolerance
        self.min_samples = max(int(min_samples), 2)
        self.cooldown = int(cooldown) if cooldown is not None else max(
            self.min_samples, window // 4)
        self.window = SlidingWindow(window)
        self.events: list[DriftEvent] = []
        self._last_swap_at = -self.cooldown  # allow an immediate first swap

    # -- statistics -----------------------------------------------------------

    def observed_shares(self) -> tuple[float, ...]:
        """Empirical tier shares of the window under CURRENT thresholds."""
        d = self.window.values()
        ts = np.asarray(self.config.thresholds)
        tiers = np.sum(d[:, None] > ts[None, :], axis=1)
        n = max(d.size, 1)
        return tuple(float(np.sum(tiers == t)) / n
                     for t in range(self.config.n_tiers))

    def fit_config(self) -> RouterConfig:
        """Thresholds hitting ``target_shares`` on the current window —
        the streaming analogue of ``calibrate.calibrate_multi_tier``."""
        cuts = np.cumsum(self.target_shares)[:-1]
        ts = [float(q) for q in self.window.quantile(cuts)]
        for i in range(1, len(ts)):     # ties can collapse; keep ascending
            ts[i] = max(ts[i], ts[i - 1])
        return dataclasses.replace(self.config, thresholds=tuple(ts))

    def quantile_source(self):
        """The window as a quantile callable (levels -> values) — the
        per-policy fit hook: routing policies with their own calibrated
        cutoffs (cascade escalation, depth buckets) re-fit from the SAME
        sample set that produced the thresholds, so a threshold hot-swap
        and its policy refit are consistent by construction. Replica sync
        passes its merged-fleet quantile instead (see
        ``distributed.replica_sync``)."""
        return lambda qs: np.asarray(self.window.quantile(np.asarray(qs)))

    # -- the streaming step ---------------------------------------------------

    def observe(self, difficulty: np.ndarray) -> Optional[RouterConfig]:
        """Absorb one batch of difficulty samples; maybe emit new config."""
        self.window.push(np.asarray(difficulty))
        if len(self.window) < self.min_samples:
            return None
        if self.window.total_seen - self._last_swap_at < self.cooldown:
            return None
        observed = self.observed_shares()
        drift = max(abs(o - t)
                    for o, t in zip(observed, self.target_shares))
        if drift <= self.tolerance:
            return None
        new = self.fit_config()
        self.events.append(DriftEvent(
            at_sample=self.window.total_seen,
            observed_shares=observed,
            target_shares=self.target_shares,
            old_thresholds=self.config.thresholds,
            new_thresholds=new.thresholds))
        self.config = new
        self._last_swap_at = self.window.total_seen
        return new

    @property
    def n_swaps(self) -> int:
        return len(self.events)

    # -- serializable state ---------------------------------------------------

    def state_dict(self) -> dict:
        """The calibrator's complete mutable state as JSON-friendly data
        (thresholds, exact sample window, swap history). Knobs/targets are
        NOT included — they are policy, carried by the config/spec."""
        return {
            "thresholds": list(self.config.thresholds),
            "window": self.window.state_dict(),
            "last_swap_at": self._last_swap_at,
            "events": [{"at_sample": e.at_sample,
                        "observed_shares": list(e.observed_shares),
                        "target_shares": list(e.target_shares),
                        "old_thresholds": list(e.old_thresholds),
                        "new_thresholds": list(e.new_thresholds)}
                       for e in self.events],
        }

    def load_state_dict(self, state: dict) -> None:
        self.config = dataclasses.replace(
            self.config, thresholds=tuple(state["thresholds"]))
        self.window.load_state_dict(state["window"])
        self._last_swap_at = int(state["last_swap_at"])
        self.events = [
            DriftEvent(at_sample=int(e["at_sample"]),
                       observed_shares=tuple(e["observed_shares"]),
                       target_shares=tuple(e["target_shares"]),
                       old_thresholds=tuple(e["old_thresholds"]),
                       new_thresholds=tuple(e["new_thresholds"]))
            for e in state["events"]]
