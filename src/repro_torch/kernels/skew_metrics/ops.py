"""Public wrapper for the fused skew-metrics kernel.

`skew_metrics` is the serving fast path: one fused pass producing all
four difficulty metrics, so downstream metric selection is a column
lookup (``METRIC_COLUMNS.index(name)``) instead of a second pass. It
runs where its input lives: the CUDA kernel for a CUDA tensor, the
kernel's plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.skew_metrics import kernel, ref
from repro_torch.kernels.skew_metrics.kernel import (  # noqa: F401
    METRIC_COLUMNS)


def skew_metrics(scores_desc, p_cdf: float = 0.95,
                 n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, K] descending-sorted (+ optional [B] n_valid) -> [B, 4].

    ``n_valid`` is clamped to [1, K] (empty rows become one degenerate
    entry; the oracle's all-false mask instead reports cumulative_k = 0,
    so route zero-hit requests before they reach the kernel)."""
    s = torch.as_tensor(scores_desc).to(torch.float32).contiguous()
    nv = None if n_valid is None else torch.as_tensor(
        n_valid, device=s.device).to(torch.int32).contiguous()
    return kernel.skew_metrics(s, nv, p_cdf=p_cdf)


skew_metrics_ref = ref.skew_metrics_ref
mask_from_n_valid = ref.mask_from_n_valid
