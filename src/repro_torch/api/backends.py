"""Pluggable difficulty backends: ONE place that decides how skew metrics
are computed.

A :class:`DifficultyBackend` is a named, swappable policy object:

* ``oracle`` — the readable PyTorch path (`repro_torch.core.skewness`, via
  the kernel's stacked ref). Ground truth; what offline evaluation wants.
* ``pallas`` — the fused single-pass skew kernel
  (`repro_torch.kernels.skew_metrics`; the name is the reference's, kept
  so a reference `RouteSpec` builds here unchanged). On the card it is a
  hand-written CUDA kernel.
* ``fused``  — the end-to-end path: the fused triple-score kernel ->
  device top-k -> fused skew kernel -> threshold decision, with scores
  never leaving device memory. Same scores-in contract as ``pallas`` for
  :meth:`~DifficultyBackend.route_batch`, plus :meth:`route_retrieved`
  for candidate-features-in routing.
* ``auto``   — the production policy: a BATCH-SIZE CROSSOVER. Batches
  below ``crossover_batch`` go to the ``oracle`` path, batches at or
  above it to the ``fused`` kernels. The crossover is a serializable
  :class:`~repro_torch.api.spec.RouteSpec` field so every replica agrees.
* ``sharded`` — a known name (so reference specs that name it validate
  and fingerprint identically) whose factory raises until the
  mesh-sharded slice is ported.

The DEVICE is never stored in a policy: every backend resolves it at
CALL time (:func:`repro_torch.kernels.device.resolve_device`: CUDA unless
it was built with ``device="cpu"``). On a CUDA tensor ``pallas``/``fused``
launch the CUDA kernels; on a CPU tensor they run the kernels' plain
PyTorch versions — the same arithmetic.

Every backend produces the SAME contract: ``[B, K]`` descending-sorted
scores (+ optional ``[B]`` ``n_valid``) -> a full
:class:`~repro_torch.core.router.RouteBatchResult` with the raw ``[B, 4]``
metric matrix in kernel column order, so the configured metric is always
a column select, whatever the backend. Backends are POLICY-AGNOSTIC: the
dispatcher's routing policy (`repro_torch.policies`) transforms their
threshold decision host-side afterwards.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.router import (RetrievedRouteResult, RouteBatchResult,
                                     RouterConfig, route_all_metrics,
                                     route_retrieved)
from repro_torch.kernels.device import DeviceLike, resolve_device

# The reference measured this on its CPU-interpret grid; it is kept as
# the spec default so reference specs route identically. Where the H100
# puts the crossover is measured by chip_smoke.py and written in PERF.md.
DEFAULT_CROSSOVER_BATCH = 32


@runtime_checkable
class DifficultyBackend(Protocol):
    """Computes skew metrics + tier assignments for score batches."""

    name: str

    def metrics(self, scores_desc, p_cdf: float = 0.95,
                n_valid=None) -> torch.Tensor:
        """[B, K] descending scores -> [B, 4] raw metrics (kernel order)."""
        ...

    def route_batch(self, scores_desc, config: RouterConfig,
                    n_valid=None) -> RouteBatchResult:
        """[B, K] -> tiers/difficulty/metrics under ``config``."""
        ...


class _SingleProgramBackend:
    """Shared machinery: both concrete backends run the whole
    metrics -> column-select -> threshold decision on one device; they
    differ only in the metric implementation (``_use_kernel``) and in
    which scoring stage :meth:`route_retrieved` puts in front.

    ``device=None`` resolves to CUDA at every call, so a backend object
    carries no device state into snapshots.
    """

    _use_kernel: bool

    def __init__(self, device: DeviceLike = None):
        self.device = device

    def effective_device(self) -> torch.device:
        """The device this call runs on — resolved NOW."""
        return resolve_device(self.device)

    def metrics(self, scores_desc, p_cdf: float = 0.95, n_valid=None):
        return self.route_batch(
            scores_desc,
            RouterConfig(metric="gini", thresholds=(0.0,),
                         cumulative_p=p_cdf), n_valid=n_valid).metrics

    def route_batch(self, scores_desc, config: RouterConfig, n_valid=None):
        dev = self.effective_device()
        scores = torch.atleast_2d(
            torch.as_tensor(scores_desc, dtype=torch.float32, device=dev))
        return route_all_metrics(
            scores, config,
            n_valid=None if n_valid is None else torch.as_tensor(
                n_valid, dtype=torch.int32, device=dev),
            use_kernel=self._use_kernel)

    def route_retrieved(self, feats, query_emb, params: Mapping,
                        config: RouterConfig,
                        n_cand=None) -> RetrievedRouteResult:
        """[B, N, Dt] candidate features + [B, Dq] queries -> full
        retrieve-to-decision output, on this backend's device."""
        dev = self.effective_device()

        def on(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        return route_retrieved(
            on(feats), on(query_emb), {k: on(v) for k, v in params.items()},
            config, n_cand=None if n_cand is None else on(n_cand,
                                                          torch.int32),
            use_kernels=self._use_kernel)


class OracleBackend(_SingleProgramBackend):
    """Plain PyTorch ground-truth backend (`core.skewness` metrics,
    stacked): no custom kernel launch."""

    name = "oracle"
    _use_kernel = False


class PallasBackend(_SingleProgramBackend):
    """Fused single-pass skew kernel backend (`kernels.skew_metrics`)."""

    name = "pallas"
    _use_kernel = True


class FusedBackend(PallasBackend):
    """The end-to-end path: the fused triple-score kernel -> device top-k
    -> fused skew kernel -> threshold decision. For pre-scored batches it
    is the ``pallas`` fast path; :meth:`route_retrieved` is the
    scores-never-leave-device-memory entry."""

    name = "fused"


class AutoBackend:
    """Batch-size crossover policy: ``oracle`` below ``crossover_batch``,
    the ``fused`` kernels at or above it. The crossover is policy, not
    environment — it lives in :class:`~repro_torch.api.spec.RouteSpec` so
    replicas agree — while the device stays call-time per host.
    """

    name = "auto"

    def __init__(self, crossover_batch: int = DEFAULT_CROSSOVER_BATCH,
                 device: DeviceLike = None):
        if crossover_batch < 1:
            raise ValueError(f"crossover_batch must be >= 1, "
                             f"got {crossover_batch}")
        self.crossover_batch = int(crossover_batch)
        self.oracle = OracleBackend(device=device)
        self.fused = FusedBackend(device=device)
        # crossover-pick counters; replaced with live instruments when a
        # session attaches its observability plane (attach_obs)
        from repro_torch.obs.registry import NULL_INSTRUMENT
        self._m_pick = {"oracle": NULL_INSTRUMENT, "fused": NULL_INSTRUMENT}

    def attach_obs(self, obs) -> None:
        """Wire the session's observability plane in: which side of the
        batch-size crossover each dispatch lands on becomes a counter
        (``backend_pick_total{path=oracle|fused}``)."""
        self._m_pick = {
            path: obs.metrics.counter("backend_pick_total", path=path)
            for path in ("oracle", "fused")}

    def effective_device(self) -> torch.device:
        return self.fused.effective_device()

    def pick(self, batch_size: int) -> DifficultyBackend:
        """The crossover in one place (bench/telemetry introspect this)."""
        side = self.oracle if batch_size < self.crossover_batch \
            else self.fused
        self._m_pick["oracle" if side is self.oracle else "fused"].inc()
        return side

    def metrics(self, scores_desc, p_cdf: float = 0.95, n_valid=None):
        scores = torch.atleast_2d(torch.as_tensor(scores_desc))
        return self.pick(scores.shape[0]).metrics(scores, p_cdf=p_cdf,
                                                  n_valid=n_valid)

    def route_batch(self, scores_desc, config: RouterConfig, n_valid=None):
        scores = torch.atleast_2d(torch.as_tensor(scores_desc))
        return self.pick(scores.shape[0]).route_batch(scores, config,
                                                      n_valid=n_valid)

    def route_retrieved(self, feats, query_emb, params: Mapping,
                        config: RouterConfig, n_cand=None):
        return self.pick(len(feats)).route_retrieved(
            feats, query_emb, params, config, n_cand=n_cand)


# --- registry ----------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., DifficultyBackend]] = {}


def register_backend(name: str,
                     factory: Callable[..., DifficultyBackend]) -> None:
    """Register a backend factory under ``name`` (RouteSpec-selectable)."""
    if not name or name == "auto":
        raise ValueError(f"invalid backend name {name!r}")
    _REGISTRY[name] = factory


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY)) + ("auto",)


def resolve_backend_name(name: str = "auto") -> str:
    """``auto`` is a first-class backend (the crossover policy): it
    resolves to itself. Kept for callers that log or validate names."""
    return name


def make_backend(name: str = "auto", **kwargs) -> DifficultyBackend:
    """Instantiate a difficulty backend by name (``auto`` = the batch-size
    crossover over oracle/fused — accepts ``crossover_batch=``; every
    built-in accepts ``device=``)."""
    if name == "auto":
        return AutoBackend(**kwargs)
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown difficulty backend {name!r}; "
                         f"choose from {available_backends()}") from None
    return factory(**kwargs)


def _make_sharded(**kwargs) -> DifficultyBackend:
    """The mesh-sharded dispatch backend is not ported yet: the name is
    registered so reference specs validate, but building one raises."""
    raise NotImplementedError(
        "the 'sharded' difficulty backend is not ported to repro_torch "
        "yet; use 'auto' (the same decisions on one device)")


register_backend("oracle", OracleBackend)
register_backend("pallas", PallasBackend)
register_backend("fused", FusedBackend)
register_backend("sharded", _make_sharded)
