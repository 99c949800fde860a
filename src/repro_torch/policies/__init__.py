"""Pluggable routing policies: what to DO with the skew metrics.

Importing this package registers the built-in strategy:

* ``threshold`` (default) — SkewRoute's published compare, bit-for-bit.

See :mod:`repro_torch.policies.base` for the protocol and registry.
"""

from repro_torch.policies.base import (PolicyDecision, PolicySpec,
                                       QuantileSource, RoutingPolicy,
                                       available_policies, build_policy,
                                       policy_spec_from_dict,
                                       register_policy)
from repro_torch.policies.threshold import ThresholdPolicy, ThresholdPolicySpec

__all__ = [
    "PolicyDecision",
    "PolicySpec",
    "QuantileSource",
    "RoutingPolicy",
    "ThresholdPolicy",
    "ThresholdPolicySpec",
    "available_policies",
    "build_policy",
    "policy_spec_from_dict",
    "register_policy",
]
