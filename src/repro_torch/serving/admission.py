"""Cost-budget admission control with SLO-aware tier-spill.

The routing policy so far reacts only to the *difficulty distribution*
(the streaming calibrator keeps tier shares on target under drift). A
production router must also react to *load*: budget burn walking past
the spend ceiling, the expensive tier's replica pool saturating, p99
blowing through the SLO. This module closes that loop — the three-way
cost/quality/latency tension from "Cost-Aware Query Routing in RAG"
(PAPERS.md) as a feedback controller around the existing training-free
machinery:

* **Budget loop** (slow, structural): an EWMA of realized $/query
  (:class:`~repro_torch.core.cost.CostModel` pricing over *executed* tiers) is
  compared against ``cost_budget_per_query``. Over budget ⇒ *tighten*
  the routing quantiles: shrink the expensive tier's target share,
  re-fit thresholds from the streaming calibrator's window, and hot-swap
  through the existing threshold-swap path
  (:meth:`~repro_torch.serving.router_service.SkewRouteDispatcher.apply_config`).
  Under budget with pressure off ⇒ *relax* back toward the spec's
  baseline shares. Mutating the calibrator's ``target_shares`` (rather
  than fighting its swaps) keeps the two controllers convergent: drift
  refits now aim at the admission-adjusted shares.

* **Spill loop** (fast, reversible): sustained expensive-tier
  saturation — queue depth or p99 pressure above ``spill_on`` — engages
  *tier-spill*: requests routed to the top tier whose difficulty sits in
  the *marginal band* just above the threshold (the ``spill_margin``
  quantile slice of the calibrator window) are demoted one tier.
  Genuinely hard requests keep the big model; only near-threshold calls
  — where the paper's Fig. 3 quality gap is smallest — trade quality for
  latency. Hysteresis (``spill_off < spill_on`` on a smoothed pressure
  signal) makes the spill state sticky, so a burst tail doesn't flap it.

Everything is deterministic, host-side, and JSON-serializable
(``state_dict``/``load_state_dict`` ride in ``session.snapshot()``), so
a replica restored from bytes resumes mid-spill with the same shares.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.core.router import RouterConfig
from repro_torch.core.streaming_calibrate import StreamingCalibrator
from repro_torch.obs import NULL_OBS, str_keyed


@dataclasses.dataclass(frozen=True)
class AdmissionSpec:
    """Admission-control policy knobs (frozen, JSON-round-trippable —
    rides inside :class:`repro_torch.api.RouteSpec`).

    Pressure is a unitless saturation signal per tier:
    ``max(queue_depth / queue_depth_slo, p99 / p99_slo)``, smoothed by
    an EWMA with weight ``pressure_beta`` on the newest sample. 1.0
    means "exactly at the configured limit". The MOST EXPENSIVE tier's
    pressure drives the tighten/relax loop and engages spill; every
    spillable tier (1..top) keeps its own hysteresis flag so demotions
    cascade PAST a saturated middle tier instead of piling onto it.
    """

    cost_budget_per_query: Optional[float] = None  # $/query ceiling
    p99_slo: Optional[float] = None                # seconds; None = ignore
    # Recency horizon of the p99 probe (seconds): load reporters only
    # quote completions this far back, so a tier that went quiet after
    # tightening doesn't show its burst-era p99 forever. Policy, not a
    # runner knob — it serializes with the spec so every replica judges
    # pressure over the same lookback. None = the reporter's default
    # (LoadRunner uses 5x its slo_latency).
    p99_horizon: Optional[float] = None
    queue_depth_slo: int = 64       # top-tier waiting depth = pressure 1.0
    spill_on: float = 1.0           # smoothed pressure that ENGAGES spill
    spill_off: float = 0.6          # ... and DISENGAGES it (hysteresis)
    spill_margin: float = 0.10      # quantile band above the top cut that
                                    # counts as "marginal" (spillable)
    tighten_step: float = 0.05      # top-tier share removed per tighten
    relax_step: float = 0.05        # ... restored per relax
    deadband: float = 0.05          # budget ratio slack around 1.0
    min_top_share: float = 0.02     # tighten floor: never starve the top
    control_interval: int = 64      # requests between quantile actions
    pressure_beta: float = 0.3      # EWMA weight of the newest sample

    def __post_init__(self):
        if (self.cost_budget_per_query is not None
                and self.cost_budget_per_query <= 0):
            raise ValueError(f"cost_budget_per_query must be > 0, got "
                             f"{self.cost_budget_per_query}")
        if self.p99_slo is not None and self.p99_slo <= 0:
            raise ValueError(f"p99_slo must be > 0, got {self.p99_slo}")
        if self.p99_horizon is not None:
            if self.p99_horizon <= 0:
                raise ValueError(f"p99_horizon must be > 0, got "
                                 f"{self.p99_horizon}")
            if self.p99_slo is not None and self.p99_horizon < self.p99_slo:
                raise ValueError(
                    f"p99_horizon ({self.p99_horizon}) < p99_slo "
                    f"({self.p99_slo}): a lookback shorter than the SLO "
                    f"cannot even contain one SLO-length completion, so "
                    f"the latency probe would never see a breach")
        if self.queue_depth_slo < 1:
            raise ValueError(f"queue_depth_slo must be >= 1, got "
                             f"{self.queue_depth_slo}")
        if not 0.0 < self.spill_off < self.spill_on:
            raise ValueError(
                f"hysteresis needs 0 < spill_off < spill_on, got "
                f"spill_off={self.spill_off}, spill_on={self.spill_on}")
        if not 0.0 < self.spill_margin < 1.0:
            raise ValueError(f"spill_margin must be in (0, 1), got "
                             f"{self.spill_margin}")
        for name in ("tighten_step", "relax_step"):
            v = getattr(self, name)
            if not 0.0 < v < 1.0:
                raise ValueError(f"{name} must be in (0, 1), got {v}")
        if not 0.0 <= self.deadband < 1.0:
            raise ValueError(f"deadband must be in [0, 1), got "
                             f"{self.deadband}")
        if not 0.0 <= self.min_top_share < 1.0:
            raise ValueError(f"min_top_share must be in [0, 1), got "
                             f"{self.min_top_share}")
        if self.control_interval < 1:
            raise ValueError(f"control_interval must be >= 1, got "
                             f"{self.control_interval}")
        if not 0.0 < self.pressure_beta <= 1.0:
            raise ValueError(f"pressure_beta must be in (0, 1], got "
                             f"{self.pressure_beta}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AdmissionSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown AdmissionSpec fields "
                             f"{sorted(unknown)}; known: {sorted(known)}")
        return cls(**dict(d))


def _finite(x) -> Optional[float]:
    """None / nan / inf -> None (the 'no signal' value)."""
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


class AdmissionController:
    """The load-feedback loop wrapped around a StreamingCalibrator.

    Lifecycle per dispatched batch (driven by
    :class:`~repro_torch.serving.pipeline.ServingPipeline`):

    1. whoever owns the replica pools feeds load probes via
       :meth:`observe_tier_load` (queue depth + p99; nan-safe);
    2. :meth:`control_step` updates the smoothed pressure, toggles spill
       with hysteresis, and — rate-limited by ``control_interval`` —
       tightens/relaxes the target shares, returning a re-fit
       :class:`RouterConfig` for the caller to hot-swap (or ``None``);
    3. :meth:`apply` demotes this batch's marginal top-tier requests
       while spill is engaged and folds the *executed* tier mix into the
       $/query EWMA the budget loop watches.

    The controller never swaps thresholds itself: it returns configs, the
    dispatcher's ``apply_config`` is the one swap path (same as drift).
    """

    def __init__(self, calibrator: StreamingCalibrator,
                 cost_model: CostModel, tier_models: Sequence[str],
                 spec: AdmissionSpec, obs=None):
        if calibrator is None:
            raise ValueError("admission control needs a streaming "
                             "calibrator (its window is the quantile "
                             "source for re-fits and the marginal band)")
        self.calibrator = calibrator
        self.cost_model = cost_model
        self.tier_models = tuple(str(m) for m in tier_models)
        self.spec = spec
        n_tiers = calibrator.config.n_tiers
        if len(self.tier_models) != n_tiers:
            raise ValueError(f"{n_tiers} tiers but "
                             f"{len(self.tier_models)} tier models")
        if n_tiers < 2:
            raise ValueError("admission control needs >= 2 tiers "
                             "(there is nowhere to spill)")
        missing = [m for m in self.tier_models
                   if m not in cost_model.cost_per_mtok]
        if spec.cost_budget_per_query is not None and missing:
            raise ValueError(
                f"cost_budget_per_query is set but tier models {missing} "
                f"have no cost_per_mtok entry — the budget loop cannot "
                f"price them")
        self._tier_cost = np.asarray(
            [cost_model.request_cost(m) if m in cost_model.cost_per_mtok
             else 0.0 for m in self.tier_models])
        self.top = n_tiers - 1
        self.baseline_shares = tuple(calibrator.target_shares)
        self.shares = tuple(calibrator.target_shares)
        # -- mutable state (all of it JSON-serializable) ----------------------
        # Per-tier pressure EWMAs + spill flags for every tier that CAN
        # spill (1..top; tier 0 has nowhere to go). The top tier's pair
        # is also exposed as .pressure/.spill_active — the legacy names
        # the 2-tier telemetry and v1 snapshots use.
        self.tier_pressure: dict[int, float] = {
            t: 0.0 for t in range(1, n_tiers)}
        self.tier_spill: dict[int, bool] = {
            t: False for t in range(1, n_tiers)}
        self.cost_per_query = None     # EWMA'd realized $/query
        self.n_seen = 0                # requests that passed apply()
        self.n_spilled = 0
        self.n_tighten = 0
        self.n_relax = 0
        self.events: list[dict] = []   # spill_on/off + tighten/relax log
        self._last_control = -spec.control_interval  # allow immediate action
        self._tier_load: dict[int, dict] = {}
        # Observability mirrors (no-ops under NULL_OBS); the counters /
        # event log above stay the serialization source.
        self.obs = obs or NULL_OBS
        m = self.obs.metrics
        self._m_spilled = m.counter("admission_spilled_total")
        self._m_tighten = m.counter("admission_tighten_total")
        self._m_relax = m.counter("admission_relax_total")
        self._g_cost = m.gauge("admission_cost_per_query")
        self._g_top_share = m.gauge("admission_top_share")
        self._g_pressure = {t: m.gauge("admission_pressure", tier=str(t))
                            for t in self.tier_pressure}
        self._g_spill = {t: m.gauge("admission_spill_engaged", tier=str(t))
                         for t in self.tier_spill}

    def _obs_resync(self) -> None:
        """Re-point the registry's admission mirrors at (restored) state."""
        if not self.obs.enabled:
            return
        self._m_spilled.value = self.n_spilled
        self._m_tighten.value = self.n_tighten
        self._m_relax.value = self.n_relax
        self._g_cost.set(self.cost_per_query or 0.0)
        self._g_top_share.set(self.shares[self.top])
        for t, g in self._g_pressure.items():
            g.set(self.tier_pressure[t])
        for t, g in self._g_spill.items():
            g.set(int(self.tier_spill[t]))

    # -- load probes ----------------------------------------------------------

    def observe_tier_load(self, tier: int, queue_depth: int,
                          p99_latency: Optional[float] = None) -> None:
        """Feed one tier's replica-pool load. ``p99_latency`` may be
        ``nan`` (TierScheduler reports nan below its completion floor) —
        treated as 'no latency signal', never as pressure."""
        self._tier_load[int(tier)] = {
            "queue_depth": int(queue_depth),
            "p99_latency": _finite(p99_latency),
        }

    def _raw_pressure(self, tier: Optional[int] = None) -> float:
        load = self._tier_load.get(self.top if tier is None else tier)
        if load is None:
            return 0.0
        p = load["queue_depth"] / self.spec.queue_depth_slo
        if self.spec.p99_slo is not None and load["p99_latency"] is not None:
            p = max(p, load["p99_latency"] / self.spec.p99_slo)
        return float(p)

    # -- legacy 2-tier names: the TOP tier's pressure/spill pair --------------

    @property
    def pressure(self) -> float:
        return self.tier_pressure[self.top]

    @property
    def spill_active(self) -> bool:
        return self.tier_spill[self.top]

    # -- the control loop ------------------------------------------------------

    def _event(self, kind: str, **extra) -> None:
        self.events.append({"at_request": self.n_seen, "kind": kind,
                            "pressure": round(self.pressure, 6),
                            "shares": list(self.shares), **extra})
        if self.obs.enabled:
            self.obs.tracer.event("admission_" + kind,
                                  at_request=self.n_seen,
                                  pressure=round(self.pressure, 6), **extra)

    def _with_top_share(self, new_top: float) -> tuple[float, ...]:
        """Current shares with the top tier moved to ``new_top``; lower
        tiers rescaled so their relative proportions are preserved."""
        cur_top = self.shares[self.top]
        lower = 1.0 - cur_top
        scale = (1.0 - new_top) / lower if lower > 1e-9 else 0.0
        out = [s * scale for s in self.shares[:-1]]
        if lower <= 1e-9:       # degenerate: everything was top tier
            out = [(1.0 - new_top) / self.top] * self.top
        out.append(new_top)
        return tuple(out)

    def control_step(self) -> Optional[RouterConfig]:
        """One feedback tick. Updates pressure + spill state every call;
        quantile tighten/relax at most once per ``control_interval``
        requests. Returns a re-fit config to hot-swap, or ``None``."""
        spec = self.spec
        for t in self.tier_pressure:
            p = self.tier_pressure[t]
            p += spec.pressure_beta * (self._raw_pressure(t) - p)
            self.tier_pressure[t] = p
            if not self.tier_spill[t] and p >= spec.spill_on:
                self.tier_spill[t] = True
                self._event("spill_on", tier=t)
            elif self.tier_spill[t] and p <= spec.spill_off:
                self.tier_spill[t] = False
                self._event("spill_off", tier=t)
            self._g_pressure[t].set(p)
            self._g_spill[t].set(int(self.tier_spill[t]))

        if self.n_seen - self._last_control < spec.control_interval:
            return None
        budget_ratio = None
        if (spec.cost_budget_per_query is not None
                and self.cost_per_query is not None):
            budget_ratio = self.cost_per_query / spec.cost_budget_per_query
        over_budget = (budget_ratio is not None
                       and budget_ratio > 1.0 + spec.deadband)
        saturated = self.pressure >= spec.spill_on
        slack = (self.pressure <= spec.spill_off
                 and (budget_ratio is None
                      or budget_ratio < 1.0 - spec.deadband))

        top = self.shares[self.top]
        new_shares = None
        if (over_budget or saturated) and top > spec.min_top_share:
            new_shares = self._with_top_share(
                max(spec.min_top_share, top - spec.tighten_step))
            kind = "tighten"
        elif slack and top < self.baseline_shares[self.top] - 1e-9:
            new_shares = self._with_top_share(
                min(self.baseline_shares[self.top], top + spec.relax_step))
            kind = "relax"
        if new_shares is None:
            return None
        # Re-fit needs a populated window; until then only the share
        # target moves (the calibrator's own drift loop will converge it).
        if len(self.calibrator.window) < self.calibrator.min_samples:
            return None
        self.shares = new_shares
        self.calibrator.target_shares = new_shares  # drift loop now aims here
        self._last_control = self.n_seen
        if kind == "tighten":
            self.n_tighten += 1
            self._m_tighten.inc()
        else:
            self.n_relax += 1
            self._m_relax.inc()
        self._g_top_share.set(self.shares[self.top])
        new_config = self.calibrator.fit_config()
        self._event(kind, budget_ratio=(None if budget_ratio is None
                                        else round(budget_ratio, 6)),
                    new_thresholds=list(new_config.thresholds))
        return new_config

    # -- spill ----------------------------------------------------------------

    def marginal_cutoff(self) -> float:
        """Difficulty value bounding the marginal band: the calibrator
        window quantile ``spill_margin`` above the top-tier cut. Top-tier
        requests AT OR BELOW it are the near-threshold calls spill may
        demote; ``nan`` while the window is too small to judge."""
        if len(self.calibrator.window) < self.calibrator.min_samples:
            return float("nan")
        cut = 1.0 - self.shares[self.top]
        q = min(1.0, cut + self.spec.spill_margin)
        return float(self.calibrator.window.quantile(q))

    def spill_target(self) -> int:
        """Where spilled top-tier requests land: the first tier below the
        top whose own spill flag is NOT engaged — a saturated middle tier
        is skipped, not piled onto. Bounded at tier 0 (which has no
        pressure flag), so the cascade always terminates."""
        target = self.top - 1
        while target > 0 and self.tier_spill[target]:
            target -= 1
        return target

    def apply(self, tiers: np.ndarray, difficulty: np.ndarray,
              request_cost: Optional[np.ndarray] = None
              ) -> tuple[np.ndarray, int]:
        """Demote this batch's marginal top-tier requests while spill is
        engaged; always folds the *executed* mix into the $/query EWMA.
        ``request_cost``: optional per-request $ the routing policy
        billed at DECISION time (cascade stage bills, depth-priced
        prompts); its per-request surcharge over the flat tier price
        survives spill adjustment, so the budget loop sees the policy's
        true spend. Returns (possibly-adjusted tiers, number spilled).
        """
        tiers = np.asarray(tiers)
        n = len(tiers)
        if n == 0:
            return tiers, 0
        # Per-request $ on top of the executed tier's flat price: zero
        # without a policy bill, so `(tier_cost + 0).mean()` reproduces
        # the pre-policy EWMA bit-for-bit.
        extra = 0.0
        if request_cost is not None:
            extra = np.asarray(request_cost) - self._tier_cost[tiers]
        spilled = 0
        if self.spill_active:
            cutoff = self.marginal_cutoff()
            if math.isfinite(cutoff):
                marginal = (tiers == self.top) & (np.asarray(difficulty)
                                                  <= cutoff)
                spilled = int(marginal.sum())
                if spilled:
                    tiers = tiers.copy()
                    tiers[marginal] = self.spill_target()
        self.n_seen += n
        self.n_spilled += spilled
        self._m_spilled.inc(spilled)
        batch_cost = float((self._tier_cost[tiers] + extra).mean())
        if self.cost_per_query is None:
            self.cost_per_query = batch_cost
        else:
            self.cost_per_query += self.spec.pressure_beta * (
                batch_cost - self.cost_per_query)
        self._g_cost.set(self.cost_per_query)
        return tiers, spilled

    # -- replica-fabric sync --------------------------------------------------

    def sync_state(self) -> dict:
        """The admission block a replica publishes in its fabric
        ``StateDelta``: just enough for the fleet to agree about spill
        and budget during a burst — per-tier smoothed pressure + spill
        flags, the $/query EWMA, the (possibly tightened) target shares,
        and ``n_seen`` as the merge weight. Deliberately NOT the full
        ``state_dict``: events/tier_load are local history, and counters
        other than ``n_seen`` don't participate in the merge."""
        return {
            "tier_pressure": str_keyed(self.tier_pressure),
            "tier_spill": str_keyed(self.tier_spill),
            "cost_per_query": self.cost_per_query,
            "shares": list(self.shares),
            "n_seen": self.n_seen,
        }

    def adopt_sync(self, merged: Mapping) -> None:
        """Adopt a deterministically merged fleet admission view (see
        ``distributed.replica_sync.merge_admission``): pressure/spill/
        budget/shares become the fleet's, local counters stay local.
        Setting ``calibrator.target_shares`` keeps the drift loop aimed
        at the merged shares — the same convergence rule as
        ``control_step``."""
        shares = tuple(float(s) for s in merged["shares"])
        if len(shares) != len(self.shares):
            raise ValueError(f"merged admission view has {len(shares)} tier "
                             f"shares, controller has {len(self.shares)}")
        for t in self.tier_pressure:
            if str(t) in merged["tier_pressure"]:
                self.tier_pressure[t] = float(merged["tier_pressure"][str(t)])
                self.tier_spill[t] = bool(merged["tier_spill"][str(t)])
        cpq = merged.get("cost_per_query")
        self.cost_per_query = None if cpq is None else float(cpq)
        self.shares = shares
        self.calibrator.target_shares = shares

    # -- telemetry / serializable state ---------------------------------------

    def telemetry(self) -> dict:
        return {
            "spill_active": self.spill_active,
            "pressure": self.pressure,
            "tier_pressure": str_keyed(self.tier_pressure),
            "tier_spill": str_keyed(self.tier_spill),
            "cost_per_query": self.cost_per_query,
            "target_shares": list(self.shares),
            "baseline_shares": list(self.baseline_shares),
            "n_seen": self.n_seen,
            "n_spilled": self.n_spilled,
            "n_tighten": self.n_tighten,
            "n_relax": self.n_relax,
            "n_events": len(self.events),
            "tier_load": {str(t): dict(v)
                          for t, v in self._tier_load.items()},
        }

    def state_dict(self) -> dict:
        """Complete mutable state, JSON-friendly (knobs live in the spec,
        baseline shares in the calibration spec — policy, not state)."""
        return {
            "shares": list(self.shares),
            # flat top-tier pair kept alongside the per-tier dicts so v1
            # 2-tier snapshots and this layout read the same way
            "spill_active": self.spill_active,
            "pressure": self.pressure,
            "tier_pressure": str_keyed(self.tier_pressure),
            "tier_spill": str_keyed(self.tier_spill),
            "cost_per_query": self.cost_per_query,
            "n_seen": self.n_seen,
            "n_spilled": self.n_spilled,
            "n_tighten": self.n_tighten,
            "n_relax": self.n_relax,
            "last_control": self._last_control,
            "events": [dict(e) for e in self.events],
            "tier_load": {str(t): dict(v)
                          for t, v in self._tier_load.items()},
        }

    def load_state_dict(self, state: Mapping) -> None:
        shares = tuple(float(s) for s in state["shares"])
        if len(shares) != len(self.shares):
            raise ValueError(f"admission state has {len(shares)} tier "
                             f"shares, controller has {len(self.shares)}")
        self.shares = shares
        self.calibrator.target_shares = shares  # keep the loops convergent
        # per-tier dicts when present; legacy flat state only knows the
        # top tier's pair (lower tiers were implicitly calm back then)
        tp = state.get("tier_pressure")
        ts = state.get("tier_spill")
        for t in self.tier_pressure:
            if tp is not None and str(t) in tp:
                self.tier_pressure[t] = float(tp[str(t)])
            elif t == self.top:
                self.tier_pressure[t] = float(state["pressure"])
            else:
                self.tier_pressure[t] = 0.0
            if ts is not None and str(t) in ts:
                self.tier_spill[t] = bool(ts[str(t)])
            elif t == self.top:
                self.tier_spill[t] = bool(state["spill_active"])
            else:
                self.tier_spill[t] = False
        cpq = state["cost_per_query"]
        self.cost_per_query = None if cpq is None else float(cpq)
        self.n_seen = int(state["n_seen"])
        self.n_spilled = int(state["n_spilled"])
        self.n_tighten = int(state["n_tighten"])
        self.n_relax = int(state["n_relax"])
        self._last_control = int(state["last_control"])
        self.events = [dict(e) for e in state["events"]]
        self._tier_load = {
            int(t): {"queue_depth": int(v["queue_depth"]),
                     "p99_latency": _finite(v["p99_latency"])}
            for t, v in state["tier_load"].items()}
