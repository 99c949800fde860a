"""The default policy: SkewRoute's published threshold compare, verbatim.

The difficulty backend already bucketed every request against
``RouteSpec.thresholds`` inside the device program; this policy passes
those tier ids through untouched and leaves ``request_cost`` unset so
the dispatcher's pre-policy per-tier cost loop runs — a spec with no
``policy=`` field routes and accounts bit-for-bit as before the policy
layer existed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.policies.base import (PolicyDecision, PolicySpec, RoutingPolicy,
                                 register_policy)

__all__ = ["ThresholdPolicySpec", "ThresholdPolicy"]


@dataclasses.dataclass(frozen=True)
class ThresholdPolicySpec(PolicySpec):
    """No knobs: the thresholds live on the RouteSpec itself."""

    kind = "threshold"


class ThresholdPolicy(RoutingPolicy):
    """Identity over the backend's threshold decision. Stateless —
    ``state_dict()`` is None, so snapshots minted under the default
    policy are indistinguishable from pre-policy envelopes."""

    def decide(self, tiers: np.ndarray, difficulty: np.ndarray,
               metrics: np.ndarray,
               self_scores: Optional[np.ndarray] = None) -> PolicyDecision:
        return PolicyDecision(tiers=np.asarray(tiers))


register_policy(ThresholdPolicySpec, ThresholdPolicy)
