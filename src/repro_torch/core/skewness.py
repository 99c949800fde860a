"""Skewness metrics over retrieved-context score distributions.

This is the mathematical heart of SkewRoute (paper §3.2/§3.3): four metrics
that quantify how concentrated ("skewed") the score distribution of the
retrieved top-K knowledge contexts is. High skew <=> simple query.

All metrics are vectorized over a leading batch dimension: ``scores`` is
``[..., K]`` (descending-sorted is NOT required; we sort internally where
the math needs it — the fused kernel in ``repro_torch.kernels.skew_metrics``
receives already-sorted top-K output from the retrieval stage).

Conventions
-----------
* Scores may be arbitrary reals (the SubgraphRAG scorer emits logits); each
  metric performs the normalization the paper specifies.
* A ``mask`` of valid entries supports ragged retrieval (fewer than K
  candidates); masked-out entries contribute nothing.
* Numerical guards: every normalization ADDS ``_EPS`` to its denominator
  (it is not a clamp), so empty / constant score vectors yield
  well-defined values. Everything is float32, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-12


def _apply_mask(scores: torch.Tensor, mask: Optional[torch.Tensor],
                fill: float) -> torch.Tensor:
    if mask is None:
        return scores
    return torch.where(mask, scores, fill)


def _valid_count(scores: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.full(scores.shape[:-1], scores.shape[-1],
                          dtype=scores.dtype, device=scores.device)
    return mask.sum(-1).to(scores.dtype)


def normalize_minmax(scores: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Min-max normalize to [0, 1] along the last axis (paper §3.2)."""
    lo = _apply_mask(scores, mask, torch.inf).amin(-1, keepdim=True)
    hi = _apply_mask(scores, mask, -torch.inf).amax(-1, keepdim=True)
    out = (scores - lo) / (hi - lo + _EPS)
    return _apply_mask(out, mask, 0.0)


def _neg_min(scores: torch.Tensor,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """min(min(valid scores), 0): the shift that makes logits
    non-negative while positive inputs pass through UNSHIFTED."""
    return _apply_mask(scores, mask, torch.inf).amin(
        -1, keepdim=True).clamp(max=0.0)


def normalize_prob(scores: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalize scores into a probability distribution (paper §3.3:
    p_i = s_i / sum_j s_j).

    The paper's scorer emits probabilities in [0,1]; raw logits are made
    non-negative by shifting with min(min, 0) — positive inputs pass
    through UNSHIFTED (shifting everything by the min would zero out
    constant vectors and change the paper's math on its own score range).
    """
    shifted = _apply_mask(scores - _neg_min(scores, mask).detach(), mask,
                          0.0)
    total = shifted.sum(-1, keepdim=True)
    return shifted / (total + _EPS)


def area_metric(scores: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area under min-max-normalized scores (paper §3.2).

    Small area  <=> high skew <=> simple query.
    Range: [0, K]. The paper's Figure-3 examples give 1.07 (power-law) and
    65.65 (flat) for K=100.
    """
    return normalize_minmax(scores, mask).sum(-1)


def cumulative_k(scores: torch.Tensor, p: float = 0.95,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cumulative-threshold metric: smallest k with CDF_k >= p (paper §3.3).

    Scores are sorted descending, normalized to a probability distribution;
    returns the (1-indexed) count of contexts needed to reach cumulative
    probability ``p``.  Small k <=> high skew <=> simple query.
    """
    probs = normalize_prob(scores, mask)
    probs = torch.sort(probs, dim=-1, descending=True).values
    cdf = torch.cumsum(probs, dim=-1)
    reached = cdf >= (p - _EPS)
    # First index where the CDF crosses p; if never (degenerate, e.g. an
    # all-zero score vector), the number of VALID contexts — returning the
    # padded width K would overstate difficulty for ragged rows.
    k = reached.to(torch.int32).argmax(-1) + 1
    any_reached = reached.any(-1)
    return torch.where(any_reached, k.to(scores.dtype),
                       _valid_count(scores, mask)).to(torch.float32)


def entropy_metric(scores: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shannon entropy (bits) of the normalized score distribution (§3.3).

    Low entropy <=> high skew <=> simple query. Range [0, log2 K].
    """
    probs = normalize_prob(scores, mask)
    plogp = torch.where(probs > _EPS, probs * torch.log2(probs + _EPS), 0.0)
    return -plogp.sum(-1)


def gini_metric(scores: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gini coefficient of the score distribution (paper §3.3).

    Uses the paper's formula over ascending-sorted scores s'_1<=...<=s'_K:

        G = (K + 1 - 2 * sum_i (K - i + 1) s'_i / sum_j s'_j) / K

    High Gini <=> high skew <=> simple query. Range [0, 1 - 1/K].
    Scores are shifted to be non-negative first (Gini is defined for
    non-negative quantities). Masked entries are treated as absent by
    computing over the shifted values with zero fill — for a correct ragged
    Gini we renormalize using the valid count.
    """
    kk = scores.shape[-1]
    shifted = _apply_mask(scores - _neg_min(scores, mask), mask, 0.0)
    asc = torch.sort(shifted, dim=-1).values
    n_valid = _valid_count(scores, mask)
    # Ranks: with zero-fill the invalid entries sort to the front and carry 0
    # weight; valid entries occupy the LAST n_valid slots. Rank within valid
    # entries (ascending, 1-indexed) is i - (K - n_valid).
    idx = torch.arange(1, kk + 1, dtype=scores.dtype, device=scores.device)
    rank_in_valid = (idx - (kk - n_valid)[..., None]).clamp(min=0.0)
    weight = n_valid[..., None] - rank_in_valid + 1.0  # (K - i + 1) over valid
    weight = torch.where(rank_in_valid > 0, weight, 0.0)
    total = asc.sum(-1)
    weighted = (weight * asc).sum(-1)
    g = (n_valid + 1.0 - 2.0 * weighted / (total + _EPS)) \
        / n_valid.clamp(min=1.0)
    return g.clamp(0.0, 1.0)


# --- registry ---------------------------------------------------------------

#: Direction convention: for every metric we expose a *difficulty score*
#: where LARGER means MORE DIFFICULT (lower skew), so a single thresholding
#: rule `difficulty > theta -> large LLM` serves all metrics.
#: area: larger = flatter = harder (already aligned).
#: cumulative_k: larger = harder (aligned).
#: entropy: larger = harder (aligned).
#: gini: larger = MORE skewed = EASIER -> negate.

def difficulty_area(scores, mask=None):
    return area_metric(scores, mask)


def difficulty_cumulative(scores, p: float = 0.95, mask=None):
    return cumulative_k(scores, p, mask)


def difficulty_entropy(scores, mask=None):
    return entropy_metric(scores, mask)


def difficulty_gini(scores, mask=None):
    return -gini_metric(scores, mask)


METRICS = {
    "area": difficulty_area,
    "cumulative": difficulty_cumulative,
    "entropy": difficulty_entropy,
    "gini": difficulty_gini,
}


def difficulty(scores: torch.Tensor, metric: str = "gini", p: float = 0.95,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compute the difficulty score for a batch of score vectors ``[..., K]``."""
    if metric == "cumulative":
        return METRICS[metric](scores, p, mask)
    return METRICS[metric](scores, mask)


def all_metrics(scores: torch.Tensor, p: float = 0.95,
                mask: Optional[torch.Tensor] = None) -> dict[str, torch.Tensor]:
    """All four difficulty metrics in one call (the fused single-pass
    version lives in ``repro_torch.kernels.skew_metrics``)."""
    return {
        "area": difficulty_area(scores, mask),
        "cumulative": difficulty_cumulative(scores, p, mask),
        "entropy": difficulty_entropy(scores, mask),
        "gini": difficulty_gini(scores, mask),
    }
