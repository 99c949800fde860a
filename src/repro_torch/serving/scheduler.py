"""Continuous-batching scheduler with straggler mitigation.

Per tier: a bounded queue feeds fixed-size decode batches (slots freed as
sequences finish — continuous batching a la Orca/vLLM, at slot
granularity). Straggler / failure handling: every request carries a
deadline; a request stuck on an unhealthy replica past its deadline is
re-dispatched to the fastest healthy replica of the SAME tier (quality is
tier-sticky; latency is not). Replica health comes from the fault-
tolerance heartbeats.

Upstream of the replica pools sits :class:`MicroBatchQueue`: the batched
dispatcher emits tier ids for a whole request batch at once, and each
tier accumulates its requests into fixed-size micro-batches so the tier
engines always see full, shape-bucketed batches (one compiled step per
bucket) instead of singleton calls. ``serving/pipeline.py`` wires
dispatch → micro-batch queues → engines → streaming recalibration into
one flow.

Runs in-process with simulated replica clocks for tests; the dispatch
logic is the deliverable (the engine call is injected).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Optional

import numpy as np

# Completions below this: latency quantiles report nan instead of a
# degenerate value (p99 over <20 samples is just the max with extra steps).
P99_MIN_SAMPLES = 20
# Latency quantiles look at the most recent completions only: a feedback
# controller needs the CURRENT tail, and a lifetime quantile never
# recovers after one burst poisons it (measured: spill stayed engaged
# forever in examples/serve_under_load.py).
P99_WINDOW = 256


@dataclasses.dataclass
class Request:
    request_id: int
    tier: int
    prompt_len: int
    max_new: int
    deadline: float
    submitted_at: float
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    replica: Optional[int] = None
    redispatched: int = 0


@dataclasses.dataclass
class Replica:
    replica_id: int
    tier: int
    healthy: bool = True
    speed: float = 1.0          # tokens/sec multiplier (1.0 = nominal)
    busy_until: float = 0.0

    def eta(self, now: float, work: float) -> float:
        return max(self.busy_until, now) + work / max(self.speed, 1e-6)


class TierScheduler:
    """Scheduler for one tier's replica pool."""

    def __init__(self, tier: int, replicas: list[Replica],
                 batch_slots: int = 8, base_token_time: float = 0.01,
                 max_redispatch: int = 1, mode: str = "kg_rag"):
        self.tier = tier
        # Execution mode this pool serves (``no_rag`` / ``kg_rag`` /
        # ``long_context``). Pure metadata to the scheduler itself; the
        # loadgen runners consult it when sizing request prompts, so a
        # ``no_rag`` tier never pays retrieval-context decode time.
        self.mode = mode
        self.replicas = {r.replica_id: r for r in replicas}
        self.batch_slots = batch_slots
        self.base_token_time = base_token_time
        self.max_redispatch = max_redispatch
        self.pending: list[tuple[float, int, Request]] = []  # (deadline, id, req)
        self.inflight: dict[int, Request] = {}
        self.done: list[Request] = []
        self.now = 0.0  # last clock seen by step(); anchors horizons

    def submit(self, req: Request) -> None:
        heapq.heappush(self.pending, (req.deadline, req.request_id, req))

    def submit_batch(self, reqs: list[Request]) -> None:
        """Admit a whole micro-batch (the batched-dispatch fast path)."""
        for req in reqs:
            self.submit(req)

    def _work(self, req: Request) -> float:
        return (req.prompt_len * 0.1 + req.max_new) * self.base_token_time

    def _pick_replica(self, now: float, work: float) -> Optional[Replica]:
        healthy = [r for r in self.replicas.values() if r.healthy]
        if not healthy:
            return None
        return min(healthy, key=lambda r: r.eta(now, work))

    def step(self, now: float) -> list[Request]:
        """Advance the scheduler clock; returns requests completed by now."""
        self.now = max(self.now, now)
        # 1. finish in-flight work
        completed = []
        for rid, req in list(self.inflight.items()):
            rep = self.replicas[req.replica]
            if rep.healthy and rep.busy_until <= now:
                req.finished_at = rep.busy_until
                completed.append(req)
                self.done.append(req)
                del self.inflight[rid]
        # 2. straggler / failure re-dispatch: dead replica always; deadline
        # overruns at most ``max_redispatch`` times — unbounded yanking
        # starves long requests forever (measured: 80/120 requests churned
        # indefinitely in examples/serve_with_routing.py)
        for rid, req in list(self.inflight.items()):
            rep = self.replicas[req.replica]
            stuck = (not rep.healthy) or (
                now > req.deadline and rep.busy_until > req.deadline
                and req.redispatched < self.max_redispatch)
            if stuck:
                del self.inflight[rid]
                req.redispatched += 1
                req.replica = None
                heapq.heappush(self.pending,
                               (now, req.request_id, req))  # front of queue
        # 3. admit pending onto replicas (slot-limited)
        while self.pending and len(self.inflight) < self.batch_slots:
            _, _, req = heapq.heappop(self.pending)
            work = self._work(req)
            rep = self._pick_replica(now, work)
            if rep is None:
                heapq.heappush(self.pending, (req.deadline, req.request_id, req))
                break
            req.replica = rep.replica_id
            req.started_at = max(now, rep.busy_until)
            rep.busy_until = rep.eta(now, work)
            self.inflight[req.request_id] = req
        return completed

    # -- health hooks ---------------------------------------------------------

    def mark_unhealthy(self, replica_id: int) -> None:
        self.replicas[replica_id].healthy = False

    def mark_healthy(self, replica_id: int, speed: float = 1.0) -> None:
        rep = self.replicas[replica_id]
        rep.healthy, rep.speed = True, speed

    # -- load probes (what the admission controller consumes) -----------------

    def queue_depth(self) -> int:
        """Requests waiting for a replica slot (excludes in-flight work)."""
        return len(self.pending)

    def latency_quantile(self, q: float,
                         min_samples: int = P99_MIN_SAMPLES,
                         window: int = P99_WINDOW,
                         horizon: Optional[float] = None) -> float:
        """Latency quantile over the last ``window`` completions (those
        that finished within ``horizon`` seconds of the current clock,
        when given), or ``nan`` below ``min_samples`` of them — a tail
        quantile over a handful of requests is one request's latency
        wearing a costume, and feeding it to a feedback controller makes
        the controller chase noise. ``horizon`` matters for the same
        reason in the other direction: a low-throughput tier keeps
        burst-era completions in a count window long after the burst, so
        a controller watching it never sees recovery. ``nan`` also means
        "tier (near-)idle over the horizon", which callers should read
        as the absence of latency pressure, not as pressure."""
        recent = self.done[-max(window, 1):]
        lats = [r.finished_at - r.submitted_at for r in recent
                if r.finished_at is not None
                and (horizon is None
                     or r.finished_at >= self.now - horizon)]
        if len(lats) < max(min_samples, 1):
            return float("nan")
        return float(np.percentile(lats, q))

    def p99_latency(self, min_samples: int = P99_MIN_SAMPLES,
                    window: int = P99_WINDOW,
                    horizon: Optional[float] = None) -> float:
        return self.latency_quantile(99, min_samples=min_samples,
                                     window=window, horizon=horizon)


def bucket_size(n: int, buckets: tuple[int, ...]) -> int:
    """Round ``n`` up to the next bucket (multiples of the last bucket
    beyond it) — shared by engine prompt-length and dispatcher batch-size
    bucketing so launched shapes stay few."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


# -- micro-batch accumulation (between dispatcher and tier engines) -----------


class MicroBatchQueue:
    """Per-tier accumulator turning a stream of routed requests into
    fixed-size micro-batches.

    The batched dispatcher assigns tiers for B requests in one kernel
    call; each tier then wants its requests executed together so the
    engine's step is reused at a stable batch shape. ``push``
    returns completed micro-batches as they fill; ``flush`` drains the
    remainder (tail of a traffic burst / shutdown).
    """

    def __init__(self, tier: int, batch_size: int = 8):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.tier = tier
        self.batch_size = batch_size
        self._items: list = []
        self.n_pushed = 0
        self.n_batches = 0

    def __len__(self) -> int:
        return len(self._items)

    def push(self, item) -> list[list]:
        """Add one routed request; returns zero or more FULL batches."""
        self._items.append(item)
        self.n_pushed += 1
        out = []
        while len(self._items) >= self.batch_size:
            out.append(self._items[:self.batch_size])
            self._items = self._items[self.batch_size:]
            self.n_batches += 1
        return out

    def push_many(self, items) -> list[list]:
        out = []
        for it in items:
            out.extend(self.push(it))
        return out

    def flush(self) -> Optional[list]:
        """Drain the partial tail batch, if any."""
        if not self._items:
            return None
        out, self._items = self._items, []
        self.n_batches += 1
        return out
