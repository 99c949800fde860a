"""Oracle: the four metrics from repro_torch.core.skewness, stacked."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import skewness


def mask_from_n_valid(n_valid: torch.Tensor, k: int) -> torch.Tensor:
    """[B] valid-prefix counts -> [B, K] boolean mask (descending top-k
    output is always a valid prefix)."""
    n_valid = torch.as_tensor(n_valid)
    return (torch.arange(k, device=n_valid.device)[None, :]
            < n_valid[:, None])


def skew_metrics_ref(scores_desc: torch.Tensor, p_cdf: float = 0.95,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, K] descending-sorted -> [B, 4] (area, cum_k, entropy, gini).

    ``mask`` mirrors the oracle's ragged support; the fused kernel's
    ``n_valid`` is the prefix special case (see ``mask_from_n_valid``).
    """
    return torch.stack([
        skewness.area_metric(scores_desc, mask),
        skewness.cumulative_k(scores_desc, p_cdf, mask),
        skewness.entropy_metric(scores_desc, mask),
        skewness.gini_metric(scores_desc, mask),
    ], dim=1)
