"""SkewRoute router: training-free, threshold-based LLM tier selection.

Implements Algorithm 1 of the paper, generalized to N tiers (paper §4.3.1
shows 3 tiers: Qwen-7b / 14b / 72b). The router consumes the *difficulty
score* (see ``repro_torch.core.skewness`` — larger = harder) and N-1
ascending thresholds; queries land in the lowest tier whose threshold
exceeds their difficulty.

The router is a frozen dataclass of plain floats — it is deliberately
trivial to serialize, replicate across serving replicas, and hot-swap when
the calibrator produces new thresholds (no weights, no training state).

Every device function here runs where its input tensors live: the fused
CUDA kernels for CUDA tensors (``use_kernel(s)=True``), their plain
PyTorch versions for CPU tensors, and the readable oracle path for
``use_kernel(s)=False`` on either device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import skewness
from repro_torch.kernels.device import to_numpy


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Configuration of a training-free skew router.

    Attributes:
      metric: one of ``area | cumulative | entropy | gini``.
      thresholds: ascending difficulty thresholds; ``len(thresholds) + 1``
        tiers. Queries with difficulty <= thresholds[0] go to tier 0 (the
        smallest model), etc.
      cumulative_p: the P of the cumulative-threshold metric (paper Fig. 9).
      top_k: number of retrieved contexts whose scores feed the metric.
    """

    metric: str = "gini"
    thresholds: tuple[float, ...] = (0.0,)
    cumulative_p: float = 0.95
    top_k: int = 100

    def __post_init__(self):
        if self.metric not in skewness.METRICS:
            raise ValueError(f"unknown metric {self.metric!r}; "
                             f"choose from {sorted(skewness.METRICS)}")
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if not 0.0 < self.cumulative_p <= 1.0:
            raise ValueError(f"cumulative_p must be in (0, 1], "
                             f"got {self.cumulative_p}")
        if len(self.thresholds) < 1:
            raise ValueError("need at least one threshold (two tiers)")
        ts = tuple(float(t) for t in self.thresholds)
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError(f"thresholds must be ascending, got {ts}")
        object.__setattr__(self, "thresholds", ts)

    @property
    def n_tiers(self) -> int:
        return len(self.thresholds) + 1


@functools.lru_cache(maxsize=512)
def _thresholds_tensor(thresholds: tuple[float, ...],
                       device: torch.device) -> torch.Tensor:
    """Device copy of a threshold tuple, cached — B=1 dispatch latency is
    overhead-dominated, and re-uploading an unchanged 8-byte tensor every
    call is pure overhead (hot-swaps produce a new tuple -> new entry)."""
    return torch.tensor(thresholds, dtype=torch.float32, device=device)


def route(scores: torch.Tensor, config: RouterConfig,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Assign each query to a tier. ``scores``: [..., K] -> tiers [...]."""
    diff = skewness.difficulty(scores, metric=config.metric,
                               p=config.cumulative_p, mask=mask)
    return route_from_difficulty(
        diff, _thresholds_tensor(config.thresholds, diff.device))


@dataclasses.dataclass(frozen=True)
class RouteBatchResult:
    """Everything the fused fast path produces for one batch.

    ``metrics`` keeps ALL four metric columns (kernel order — see
    ``repro_torch.kernels.skew_metrics.kernel.METRIC_COLUMNS``) so
    telemetry and the streaming calibrator get the full picture for free.
    """

    tiers: torch.Tensor        # [B] int32
    difficulty: torch.Tensor   # [B] float32, larger = harder
    metrics: torch.Tensor      # [B, 4] float32 raw metric values


def difficulty_from_metrics(metrics: torch.Tensor,
                            metric: str) -> torch.Tensor:
    """Column-select one metric from the fused [B, 4] output and orient it
    as a difficulty score (larger = harder). Gini is the only metric where
    high skew = high value, so it is negated (see skewness registry)."""
    from repro_torch.kernels.skew_metrics.kernel import METRIC_COLUMNS
    try:
        col = METRIC_COLUMNS.index(metric)
    except ValueError:
        raise ValueError(f"unknown metric {metric!r}; "
                         f"choose from {sorted(METRIC_COLUMNS)}") from None
    sign = -1.0 if metric == "gini" else 1.0
    return sign * metrics[..., col]


def _decision_program(scores_desc: torch.Tensor, thresholds: torch.Tensor,
                      n_valid: Optional[torch.Tensor], *, metric: str,
                      p_cdf: float, ragged: bool, use_kernel: bool):
    """metrics -> column select -> threshold compare: a routing decision
    is the same three steps whichever metric implementation (fused CUDA
    kernel or the oracle) feeds it. Thresholds ride along as a tensor, so
    calibration hot-swaps change data, not code."""
    if use_kernel:
        from repro_torch.kernels.skew_metrics import ops as skew_ops
        metrics = skew_ops.skew_metrics(scores_desc, p_cdf=p_cdf,
                                        n_valid=n_valid if ragged else None)
    else:
        from repro_torch.kernels.skew_metrics.ref import (mask_from_n_valid,
                                                          skew_metrics_ref)
        mask = (mask_from_n_valid(n_valid, scores_desc.shape[-1])
                if ragged else None)
        metrics = skew_metrics_ref(scores_desc, p_cdf=p_cdf, mask=mask)
    diff = difficulty_from_metrics(metrics, metric)
    tiers = route_from_difficulty(diff, thresholds)
    return tiers, diff, metrics


def route_all_metrics(scores_desc: torch.Tensor, config: RouterConfig,
                      n_valid: Optional[torch.Tensor] = None,
                      use_kernel: bool = True) -> RouteBatchResult:
    """Batched fast path: the fused skew-metrics kernel (its plain version
    for a CPU tensor) computes all four metrics, then the column select
    and the threshold compare — no per-metric passes, no per-request
    calls, no host hop between metrics and decision.

    ``scores_desc``: [B, K] descending-sorted top-K retrieval scores.
    ``n_valid``: optional [B] valid-prefix counts for ragged retrieval.
    ``use_kernel=False`` swaps in the oracle metrics (what the ``oracle``
    difficulty backend runs).
    """
    tiers, diff, metrics = _decision_program(
        scores_desc, _thresholds_tensor(config.thresholds,
                                        scores_desc.device), n_valid,
        metric=config.metric, p_cdf=config.cumulative_p,
        ragged=n_valid is not None, use_kernel=use_kernel)
    return RouteBatchResult(tiers=tiers, difficulty=diff, metrics=metrics)


def route_from_difficulty(difficulty: torch.Tensor,
                          thresholds: torch.Tensor) -> torch.Tensor:
    """Bucket difficulty scores by ascending thresholds -> int32 tier ids.

    tier = #thresholds strictly below the difficulty value, i.e.
    ``difficulty <= t[0]`` -> 0 (smallest model), ``> t[-1]`` -> N-1.
    """
    thresholds = torch.as_tensor(thresholds, device=difficulty.device)
    return (difficulty[..., None] > thresholds).sum(-1).to(torch.int32)


def route_binary(scores: torch.Tensor, config: RouterConfig,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper's two-tier form: True -> large LLM (F_L), False -> small (F_S)."""
    return route(scores, config, mask) > 0


def select_depths(difficulty: torch.Tensor, depth_cutoffs: torch.Tensor,
                  depth_options: torch.Tensor) -> torch.Tensor:
    """Route retrieval DEPTH per query: bucket difficulty by ascending
    cutoffs (the same compare as :func:`route_from_difficulty`) and pick
    the matching depth option — easy (high-skew) queries take a shallow
    k, flat distributions the deep one. Cutoffs and options ride along
    as tensors so depth-policy refits change data, not code."""
    bucket = route_from_difficulty(difficulty, depth_cutoffs)
    options = torch.as_tensor(depth_options, dtype=torch.int32,
                              device=difficulty.device)
    return options[bucket.long()]


# -- end-to-end: retrieval scoring -> top-k -> skew -> decision ---------------

_NEG_INF = -1e30  # masks padded/invalid candidates out of top-k


@dataclasses.dataclass(frozen=True)
class RetrievedRouteResult:
    """Everything the fused retrieve-to-decision path produces.

    ``indices``/``probs`` are the top-K retrieval output (candidate index
    into the per-query feature rows, sigmoid score in [0, 1], descending);
    ``n_valid`` counts the usable leading entries per row (< K when a
    query had fewer than K candidates). The routing triple
    (tiers/difficulty/metrics) matches :class:`RouteBatchResult`.
    """

    indices: torch.Tensor      # [B, K] int32 candidate indices, desc by score
    probs: torch.Tensor        # [B, K] float32 sigmoid scores
    n_valid: torch.Tensor      # [B] int32 usable prefix (= min(n_cand, K))
    tiers: torch.Tensor        # [B] int32
    difficulty: torch.Tensor   # [B] float32
    metrics: torch.Tensor      # [B, 4] float32


def topk_sigmoid_decision(logits: torch.Tensor, thresholds: torch.Tensor,
                          n_cand: Optional[torch.Tensor], *, top_k: int,
                          metric: str, p_cdf: float, ragged: bool,
                          use_kernel: bool):
    """The decision tail shared by every retrieve-to-decision path:
    candidate logits [B, N] -> ragged mask -> device top-k -> sigmoid ->
    skew metrics -> threshold compare."""
    b, n = logits.shape
    if ragged:
        nc = torch.as_tensor(n_cand, device=logits.device).to(
            torch.int32).clamp(1, n)
        col = torch.arange(n, dtype=torch.int32, device=logits.device)
        logits = torch.where(col[None, :] < nc[:, None], logits, _NEG_INF)
        nv = nc.clamp(max=top_k)
    else:
        nv = torch.full((b,), min(n, top_k), dtype=torch.int32,
                        device=logits.device)
    vals, idx = torch.topk(logits, top_k, dim=1)  # descending by score
    probs = torch.sigmoid(vals)                    # paper scores are [0, 1]
    tiers, diff, metrics = _decision_program(
        probs, thresholds, nv, metric=metric, p_cdf=p_cdf, ragged=True,
        use_kernel=use_kernel)
    return idx.to(torch.int32), probs, nv, tiers, diff, metrics


def score_candidates(feats: torch.Tensor, query_emb: torch.Tensor,
                     w1_t, w1_q, b1, w2, b2, *,
                     use_kernels: bool) -> torch.Tensor:
    """[B, N, Dt] features + [B, Dq] queries -> [B, N] candidate logits
    (the fused `triple_score_batched` kernel or its oracle)."""
    if use_kernels:
        from repro_torch.kernels.triple_score import ops as ts_ops
        return ts_ops.triple_score_batched(feats, query_emb, w1_t, w1_q, b1,
                                           w2, b2)
    from repro_torch.kernels.triple_score.ref import triple_score_batched_ref
    return triple_score_batched_ref(feats, query_emb, w1_t, w1_q, b1, w2, b2)


def route_retrieved(feats: torch.Tensor, query_emb: torch.Tensor,
                    params: Mapping[str, torch.Tensor], config: RouterConfig,
                    n_cand: Optional[torch.Tensor] = None,
                    use_kernels: bool = True) -> RetrievedRouteResult:
    """Fused end-to-end routing: per-query candidate features in, tier
    decisions out, with zero host round-trips in between.

    ``feats``: [B, N, Dt] per-query candidate triple features (padded to a
    common N; see `repro_torch.retrieval.scorer.batch_triple_features`).
    ``query_emb``: [B, Dq]. ``params``: the scorer weight dict — its
    layout (``w1_t``/``w1_q``/``b1``/``w2``/``b2``) is the triple-score
    kernel's argument order, making the kernel a drop-in.
    ``n_cand``: optional [B] real candidate counts (ragged retrieval);
    padded rows beyond ``n_cand`` are masked out of the top-k.
    ``use_kernels=False`` runs the identical chain on the oracle ops.
    Everything runs on ``feats``' device.
    """
    k = min(config.top_k, feats.shape[1])
    logits = score_candidates(
        feats, query_emb, params["w1_t"], params["w1_q"], params["b1"],
        params["w2"], params["b2"], use_kernels=use_kernels)
    idx, probs, nv, tiers, diff, metrics = topk_sigmoid_decision(
        logits, _thresholds_tensor(config.thresholds, feats.device),
        n_cand, top_k=k, metric=config.metric, p_cdf=config.cumulative_p,
        ragged=n_cand is not None, use_kernel=use_kernels)
    return RetrievedRouteResult(indices=idx, probs=probs, n_valid=nv,
                                tiers=tiers, difficulty=diff, metrics=metrics)


def route_retrieved_staged(feats, query_emb, params: Mapping,
                           config: RouterConfig,
                           n_cand=None) -> RetrievedRouteResult:
    """The readable host-staged reference for :func:`route_retrieved` —
    exactly what the pre-fusion serving path did per request, on the
    CPU: oracle scoring, numpy argsort top-k, sigmoid, then the oracle
    skew metrics and threshold compare. Used by the parity tests and as
    the end-to-end baseline; never the serving path.
    """
    from repro_torch.kernels.skew_metrics.ref import (mask_from_n_valid,
                                                      skew_metrics_ref)
    from repro_torch.kernels.triple_score.ref import triple_score_ref

    feats = to_numpy(feats)
    query_emb = to_numpy(query_emb)
    w = {name: torch.as_tensor(to_numpy(params[name]))
         for name in ("w1_t", "w1_q", "b1", "w2", "b2")}
    b, n, _ = feats.shape
    k = min(config.top_k, n)
    nc = (np.full(b, n, np.int32) if n_cand is None
          else np.clip(to_numpy(n_cand).astype(np.int32), 1, n))
    idx = np.zeros((b, k), np.int32)
    probs = np.zeros((b, k), np.float32)
    nv = np.minimum(nc, k).astype(np.int32)
    for i in range(b):
        scores = triple_score_ref(
            torch.as_tensor(feats[i, :nc[i]]),
            torch.as_tensor(query_emb[i][None]),
            w["w1_t"], w["w1_q"], w["b1"], w["w2"], w["b2"]).numpy()[0]
        order = np.argsort(-scores, kind="stable")[:k]
        idx[i, :len(order)] = order
        probs[i, :len(order)] = 1.0 / (1.0 + np.exp(-scores[order]))
    mask = mask_from_n_valid(torch.as_tensor(nv), k)
    metrics = skew_metrics_ref(torch.as_tensor(probs),
                               p_cdf=config.cumulative_p, mask=mask)
    diff = difficulty_from_metrics(metrics, config.metric)
    tiers = route_from_difficulty(
        diff, _thresholds_tensor(config.thresholds, diff.device))
    return RetrievedRouteResult(indices=torch.as_tensor(idx),
                                probs=torch.as_tensor(probs),
                                n_valid=torch.as_tensor(nv), tiers=tiers,
                                difficulty=diff, metrics=metrics)


@dataclasses.dataclass(frozen=True)
class RoutingStats:
    """Aggregate telemetry for a routed batch (exported by the dispatcher)."""

    tier_counts: tuple[int, ...]
    large_call_ratio: float  # fraction sent to the top tier
    mean_difficulty: float

    @staticmethod
    def from_assignments(tiers: torch.Tensor, n_tiers: int,
                         difficulty: torch.Tensor) -> "RoutingStats":
        tiers = torch.as_tensor(tiers)
        counts = tuple(int((tiers == t).sum()) for t in range(n_tiers))
        n = max(int(tiers.numel()), 1)
        return RoutingStats(
            tier_counts=counts,
            large_call_ratio=counts[-1] / n,
            mean_difficulty=float(torch.as_tensor(difficulty).mean()),
        )


def expected_tier_shares(difficulty: torch.Tensor,
                         thresholds: Sequence[float]) -> list[float]:
    """Empirical share of traffic per tier for a difficulty sample."""
    difficulty = torch.as_tensor(difficulty)
    tiers = route_from_difficulty(
        difficulty, _thresholds_tensor(tuple(float(t) for t in thresholds),
                                       difficulty.device))
    n = max(int(tiers.numel()), 1)
    return [float((tiers == t).sum()) / n
            for t in range(len(tuple(thresholds)) + 1)]
