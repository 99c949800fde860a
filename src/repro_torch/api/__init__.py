"""`repro_torch.api` — the unified, declarative SkewRoute routing surface.

The entire routing policy is one JSON-round-trippable value; running it
is one call:

    from repro_torch.api import RouteSpec, build

    spec = RouteSpec(metric="gini", thresholds=(theta,),
                     tier_names=("qwen7b", "qwen72b"))
    session = build(spec)                  # or build(spec, runners=bank)
    result = session.route(scores_desc)    # [B, K] -> tiers + telemetry

Policies ship between replicas as bytes (`spec.to_json()` /
`RouteSpec.from_json`), live state ships as `session.snapshot()` /
`restore()`. Difficulty computation is a named, registered backend
(``oracle`` | ``pallas`` | ``fused`` | ``auto``) — see
`repro_torch.api.backends`; ``auto`` is the production batch-size crossover
(oracle below ``spec.crossover_batch``, the fused end-to-end CUDA kernels
at or above it). The session runs on CUDA unless built with
``device="cpu"``; the device is never part of the spec or a snapshot.

What the session DOES with the skew metrics is a registered routing
policy selected by ``spec.policy`` — see `repro_torch.policies` (this
port registers ``threshold``); ``policy=None`` is the default threshold
compare.
"""

from repro_torch.api.backends import (  # noqa: F401
    DEFAULT_CROSSOVER_BATCH,
    AutoBackend,
    DifficultyBackend,
    FusedBackend,
    OracleBackend,
    PallasBackend,
    available_backends,
    make_backend,
    register_backend,
    resolve_backend_name,
)
from repro_torch.api.spec import (  # noqa: F401
    ENVELOPE_VERSION,
    SCHEMA_VERSION,
    AdmissionSpec,
    CalibrationSpec,
    CostSpec,
    RouteSpec,
    policy_fingerprint,
)
from repro_torch.api.session import (  # noqa: F401
    EngineBankLike,
    SkewRouteSession,
    build,
)
from repro_torch.kernels.device import resolve_device  # noqa: F401
from repro_torch.policies import (  # noqa: F401
    PolicySpec,
    ThresholdPolicySpec,
    available_policies,
    build_policy,
    policy_spec_from_dict,
)
