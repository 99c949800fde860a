"""Training-free threshold calibration.

The paper sweeps thresholds to trace the performance-vs-cost curve (Figs
5-9). Operationally a deployment wants the inverse: *given a target
large-LLM call ratio rho (a budget), find theta*. Because the router is a
monotone threshold rule, theta is exactly the (1 - rho)-quantile of the
difficulty metric over any unlabeled calibration sample — no labels, no
training, preserving the paper's training-free property.

Also provides the full sweep used by the benchmark harness to reproduce the
paper's routing curves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import skewness
from repro_torch.core.router import RouterConfig
from repro_torch.kernels.device import to_numpy


def _tensors(scores, mask):
    scores = torch.as_tensor(scores)
    return scores, (None if mask is None
                    else torch.as_tensor(mask, device=scores.device))


def calibrate_threshold(
    scores: torch.Tensor,
    target_large_ratio: float,
    metric: str = "gini",
    cumulative_p: float = 0.95,
    mask: Optional[torch.Tensor] = None,
) -> float:
    """theta s.t. ~``target_large_ratio`` of queries route to the large tier.

    Quantile matching on an unlabeled calibration set: difficulty is
    monotone in "hardness", so the (1-rho)-quantile of the difficulty
    distribution sends the top-rho hardest queries to F_L.
    """
    if not 0.0 <= target_large_ratio <= 1.0:
        raise ValueError(f"target_large_ratio must be in [0,1], got {target_large_ratio}")
    scores, mask = _tensors(scores, mask)
    diff = skewness.difficulty(scores, metric=metric, p=cumulative_p, mask=mask)
    q = min(max(1.0 - target_large_ratio, 0.0), 1.0)
    # linear interpolation, the reference's quantile rule too
    return float(torch.quantile(diff, q))


def calibrate_multi_tier(
    scores: torch.Tensor,
    tier_shares: Sequence[float],
    metric: str = "gini",
    cumulative_p: float = 0.95,
    mask: Optional[torch.Tensor] = None,
) -> RouterConfig:
    """Thresholds for N tiers with the given traffic shares (sum to 1).

    ``tier_shares[i]`` is the desired fraction of traffic on tier i
    (ascending model size). Returns a ready-to-use RouterConfig.
    """
    shares = np.asarray(list(tier_shares), dtype=np.float64)
    if shares.ndim != 1 or len(shares) < 2:
        raise ValueError("need >= 2 tier shares")
    if np.any(shares < 0) or not np.isclose(shares.sum(), 1.0, atol=1e-6):
        raise ValueError(f"tier shares must be >= 0 and sum to 1, got {shares}")
    scores, mask = _tensors(scores, mask)
    diff = skewness.difficulty(scores, metric=metric, p=cumulative_p, mask=mask)
    cuts = np.cumsum(shares)[:-1]  # quantile cut points
    thresholds = tuple(float(torch.quantile(diff, float(c))) for c in cuts)
    # Enforce strictly ascending (ties can collapse with discrete metrics).
    ts = list(thresholds)
    for i in range(1, len(ts)):
        ts[i] = max(ts[i], ts[i - 1])
    return RouterConfig(metric=metric, thresholds=tuple(ts),
                        cumulative_p=cumulative_p, top_k=scores.shape[-1])


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    threshold: float
    large_call_ratio: float
    quality: float  # Hit@1 or F1 depending on the evaluator
    cost: float     # $ per query under the cost model


def sweep_thresholds(
    difficulty: torch.Tensor,
    quality_small: torch.Tensor,
    quality_large: torch.Tensor,
    cost_small: torch.Tensor,
    cost_large: torch.Tensor,
    n_points: int = 21,
) -> list[SweepPoint]:
    """Trace the performance-cost curve (paper Figs 5/6/8/9).

    ``quality_*``: per-query quality (1/0 hit or F1 in [0,1]) under each
    tier; ``cost_*``: per-query cost. The sweep moves theta across the
    difficulty quantiles so point i routes the hardest i/(n-1) fraction
    large.
    """
    diff = to_numpy(difficulty).astype(np.float64)
    qs = to_numpy(quality_small).astype(np.float64)
    ql = to_numpy(quality_large).astype(np.float64)
    cs = to_numpy(cost_small).astype(np.float64)
    cl = to_numpy(cost_large).astype(np.float64)
    points: list[SweepPoint] = []
    for i in range(n_points):
        rho = i / max(n_points - 1, 1)
        theta = float(np.quantile(diff, 1.0 - rho)) if rho > 0 else float(diff.max()) + 1.0
        large = diff > theta
        # guarantee exact-ish ratio under ties by nudging
        ratio = float(large.mean())
        quality = float(np.where(large, ql, qs).mean())
        cost = float(np.where(large, cl, cs).mean())
        points.append(SweepPoint(threshold=theta, large_call_ratio=ratio,
                                 quality=quality, cost=cost))
    return points


def random_mix_curve(
    quality_small: torch.Tensor,
    quality_large: torch.Tensor,
    cost_small: torch.Tensor,
    cost_large: torch.Tensor,
    n_points: int = 21,
    seed: int = 0,
) -> list[SweepPoint]:
    """The paper's random-mixing baseline: route a uniform-random rho
    fraction of queries to the large model."""
    rng = np.random.default_rng(seed)
    qs = to_numpy(quality_small).astype(np.float64)
    ql = to_numpy(quality_large).astype(np.float64)
    cs = to_numpy(cost_small).astype(np.float64)
    cl = to_numpy(cost_large).astype(np.float64)
    n = qs.shape[0]
    order = rng.permutation(n)
    points = []
    for i in range(n_points):
        rho = i / max(n_points - 1, 1)
        cutoff = int(round(rho * n))
        large = np.zeros(n, dtype=bool)
        large[order[:cutoff]] = True
        points.append(SweepPoint(
            threshold=float("nan"),
            large_call_ratio=float(large.mean()),
            quality=float(np.where(large, ql, qs).mean()),
            cost=float(np.where(large, cl, cs).mean()),
        ))
    return points


def oracle_curve(
    quality_small: torch.Tensor,
    quality_large: torch.Tensor,
    cost_small: torch.Tensor,
    cost_large: torch.Tensor,
    n_points: int = 21,
) -> list[SweepPoint]:
    """Upper bound: an omniscient router that sends exactly the queries the
    small model fails (and the large model solves) to the large model first."""
    qs = to_numpy(quality_small).astype(np.float64)
    ql = to_numpy(quality_large).astype(np.float64)
    cs = to_numpy(cost_small).astype(np.float64)
    cl = to_numpy(cost_large).astype(np.float64)
    gain = ql - qs
    order = np.argsort(-gain)  # biggest win first
    n = qs.shape[0]
    points = []
    for i in range(n_points):
        rho = i / max(n_points - 1, 1)
        cutoff = int(round(rho * n))
        large = np.zeros(n, dtype=bool)
        large[order[:cutoff]] = True
        points.append(SweepPoint(
            threshold=float("nan"),
            large_call_ratio=float(large.mean()),
            quality=float(np.where(large, ql, qs).mean()),
            cost=float(np.where(large, cl, cs).mean()),
        ))
    return points
