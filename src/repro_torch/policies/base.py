"""The `RoutingPolicy` protocol and registry: what to DO with skew metrics.

SkewRoute's published router is one rule — compare a skew-derived
difficulty score against ascending thresholds. Everything upstream of
that rule (scoring, top-k, the fused metric kernels, calibration
windows) is policy-agnostic machinery; this package lifts the rule
itself into a registered strategy so a :class:`~repro_torch.api.RouteSpec` can
express cascade routing, per-query retrieval depth, or retrieval-mode
selection without new user-facing surface.

The contract, in dispatch order:

1. the difficulty backend produces the batch's threshold-tier ids,
   difficulty scores, and the raw metric matrix (unchanged — backends
   stay policy-agnostic and the fused device programs stay compiled
   once);
2. the dispatcher hands those arrays to ``policy.decide(...)``, which
   returns a :class:`PolicyDecision`: final tier ids, an optional
   per-request $ cost override (cascades pay every stage they ran;
   depth/mode policies price per-request token counts), an optional
   per-request retrieval depth, and telemetry;
3. counters, the $ ledger, admission's budget EWMA, and the micro-batch
   queues all consume the DECISION, so per-stage accounting flows
   end-to-end.

Calibration: a policy with data-dependent cutoffs implements
:meth:`RoutingPolicy.refit`, which receives a *quantile source* — a
callable mapping quantile levels to values over whatever sample set is
authoritative right now (the local streaming window on a drift swap, the
weighted fleet merge in a sync round). Every threshold hot-swap goes
through ``dispatcher.apply_config``; the policy refit rides the same
path, so replicas that merged identical windows land on identical policy
cutoffs — the fabric's replicas-agree-exactly property extends to
policies for free.

Serialization: specs are frozen dataclasses with a ``kind``
discriminator (JSON dict ``{"kind": ..., <fields>}``); mutable policy
state (live cutoffs, escalation counters) rides the snapshot envelope's
state half next to the calibrator window. A stateless policy serializes
its state as ``None``, which keeps pre-policy (PR 8) envelopes loading
unchanged under the default threshold policy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.cost import CostModel

__all__ = [
    "PolicyDecision",
    "PolicySpec",
    "QuantileSource",
    "RoutingPolicy",
    "available_policies",
    "build_policy",
    "policy_spec_from_dict",
    "register_policy",
]

#: Maps ascending quantile levels in [0, 1] -> sample values. The
#: streaming calibrator provides one over its window; the replica-sync
#: merge provides one over the weighted fleet union.
QuantileSource = Callable[[Sequence[float]], np.ndarray]


def bucketize(values: np.ndarray, cutoffs: Sequence[float]) -> np.ndarray:
    """Host-side twin of `core.router.route_from_difficulty`: bucket id =
    number of ascending cutoffs strictly below the value. The SAME
    compare (strict ``>``) as the device program, so a policy cutoff and
    a router threshold at the same value bucket identically."""
    v = np.asarray(values)
    cuts = np.asarray(tuple(cutoffs), dtype=v.dtype if v.dtype.kind == "f"
                      else np.float32)
    return np.sum(v[:, None] > cuts[None, :], axis=1).astype(np.int32)


def ascending(values: Sequence[float]) -> tuple[float, ...]:
    """Clamp a cutoff sequence ascending (quantile ties can collapse) —
    the same rule `StreamingCalibrator.fit_config` applies."""
    out = [float(v) for v in values]
    for i in range(1, len(out)):
        out[i] = max(out[i], out[i - 1])
    return tuple(out)


@dataclasses.dataclass
class PolicyDecision:
    """What a policy decided for one dispatched batch.

    ``tiers`` are the FINAL tier ids the batch executes on (and what
    every downstream counter records). ``request_cost`` — when not None —
    overrides the dispatcher's default price-by-final-tier accounting
    with per-request $ (a cascade pays every stage it attempted; a depth
    policy pays per-request prompt tokens). ``depths`` — when not None —
    is the per-request retrieval depth the retrieval output is truncated
    to. ``info`` is policy-specific batch telemetry.
    """

    tiers: np.ndarray
    request_cost: Optional[np.ndarray] = None
    depths: Optional[np.ndarray] = None
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Base of the frozen, JSON-round-trippable policy spec family.

    Subclasses set the class attribute ``kind`` (the registry key and
    JSON discriminator) and may override :meth:`validate`, which runs
    inside ``RouteSpec.__post_init__`` with the enclosing spec — the one
    place cross-field invariants (tier counts, top_k bounds) live.
    """

    kind = "?"  # class attribute, not a field — overridden per subclass

    def validate(self, route_spec) -> None:  # noqa: ARG002 (interface)
        """Check this policy against the enclosing RouteSpec."""

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"kind": type(self).kind}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        return d


class RoutingPolicy:
    """Runtime half of a policy: spec + live cutoffs + counters.

    Built by :func:`build_policy` with the routing context a decision
    needs (tier count, cost-model pricing per tier). Subclasses override
    :meth:`decide`; stateful ones also ``refit``/``state_dict``/
    ``load_state_dict``.
    """

    #: True when the policy owns data-dependent cutoffs that should be
    #: re-fit from the quantile source on every threshold hot-swap.
    needs_refit = False

    def __init__(self, spec: PolicySpec, *, n_tiers: int,
                 tier_models: Sequence[str], cost_model: CostModel):
        if len(tier_models) != n_tiers:
            raise ValueError(f"{n_tiers} tiers but {len(tier_models)} "
                             f"tier models")
        self.spec = spec
        self.n_tiers = int(n_tiers)
        self.tier_models = tuple(str(m) for m in tier_models)
        self.cost_model = cost_model
        # $/request by final tier — 0.0 for models the pricing table
        # doesn't know, matching the dispatcher's default ledger
        self.tier_cost = np.asarray(
            [cost_model.request_cost(m) if m in cost_model.cost_per_mtok
             else 0.0 for m in self.tier_models])

    @property
    def kind(self) -> str:
        return type(self.spec).kind

    # -- the decision ---------------------------------------------------------

    def decide(self, tiers: np.ndarray, difficulty: np.ndarray,
               metrics: np.ndarray,
               self_scores: Optional[np.ndarray] = None) -> PolicyDecision:
        raise NotImplementedError

    # -- calibration (no-op for cutoff-free policies) -------------------------

    def refit(self, quantile_source: QuantileSource) -> None:
        """Re-fit live cutoffs from the given quantile source. Called on
        every threshold hot-swap (drift refit, admission tighten/relax,
        fleet merge) with the source that produced the new thresholds."""

    # -- serializable state ---------------------------------------------------

    def state_dict(self) -> Optional[dict]:
        """Mutable policy state for the snapshot envelope; ``None`` for a
        stateless policy (which keeps pre-policy envelopes bit-stable)."""
        return None

    def load_state_dict(self, state: Optional[Mapping]) -> None:
        if state is not None:
            raise ValueError(
                f"policy {self.kind!r} is stateless but the snapshot "
                f"carries policy state {sorted(state)}; the snapshot was "
                f"minted under a different policy")

    def telemetry(self) -> dict:
        return {"kind": self.kind}


# -- registry -----------------------------------------------------------------

_REGISTRY: dict[str, tuple[type[PolicySpec], type[RoutingPolicy]]] = {}


def register_policy(spec_cls: type[PolicySpec],
                    policy_cls: type[RoutingPolicy]) -> None:
    """Register a (spec, runtime) pair under ``spec_cls.kind`` — the name
    a RouteSpec selects and the JSON discriminator."""
    kind = spec_cls.kind
    if not kind or kind == "?":
        raise ValueError(f"policy spec {spec_cls.__name__} must define a "
                         f"kind class attribute")
    _REGISTRY[kind] = (spec_cls, policy_cls)


def available_policies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def policy_spec_from_dict(d: Mapping[str, Any]) -> PolicySpec:
    """JSON dict (``{"kind": ..., <fields>}``) -> the concrete spec,
    with the same strict unknown-field rejection as RouteSpec."""
    d = dict(d)
    kind = d.pop("kind", None)
    if kind not in _REGISTRY:
        raise ValueError(f"unknown routing policy {kind!r}; choose from "
                         f"{available_policies()}")
    spec_cls, _ = _REGISTRY[kind]
    known = {f.name for f in dataclasses.fields(spec_cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown {spec_cls.__name__} fields "
                         f"{sorted(unknown)}; known: {sorted(known)}")
    for key, value in d.items():
        if isinstance(value, list):
            d[key] = tuple(value)
    return spec_cls(**d)


def build_policy(spec: Optional[PolicySpec], *, n_tiers: int,
                 tier_models: Sequence[str],
                 cost_model: CostModel) -> RoutingPolicy:
    """Spec -> runtime policy. ``None`` builds the default threshold
    policy — exactly today's compare, bit-for-bit."""
    if spec is None:
        from repro_torch.policies.threshold import ThresholdPolicySpec
        spec = ThresholdPolicySpec()
    _, policy_cls = _REGISTRY[type(spec).kind]
    return policy_cls(spec, n_tiers=n_tiers, tier_models=tier_models,
                      cost_model=cost_model)
