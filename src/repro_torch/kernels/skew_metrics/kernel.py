"""Fused skewness-metric kernel — the SkewRoute router fast path.

Every request pays this op (paper Algorithm 1): given the top-K retrieval
scores (descending-sorted, as emitted by top-k), compute all four
difficulty metrics in ONE pass over each row:

  col 0  area          sum(minmax-normalized)
  col 1  cumulative-k  #contexts to reach CDF >= P
  col 2  entropy       -sum p log2 p
  col 3  gini          (K+1 - 2 sum (K-i+1) s'_i / sum) / K

Replaces the TPU kernel ``src/repro/kernels/skew_metrics/kernel.py``
(``skew_metrics``, body ``_skew_kernel``). The CUDA source is
``repro_torch/kernels/csrc/skew_metrics.cu``: one warp per row, all
reductions as warp shuffles, memory-bound (K floats in, 4 out per row).
The descending order is exploited as in the reference: the CDF is a
running sum and the Gini weight of column ``c`` is ``c + 1``. An optional
per-row ``n_valid`` (clamped to [1, K]) masks ragged rows.

:func:`skew_metrics` launches the kernel for a CUDA tensor and takes
:func:`skew_metrics_plain` — the same arithmetic in plain PyTorch — only
for a CPU tensor. Both accumulate the row sums in double and round once,
so ``cumulative_k`` (a compare of the CDF against P) agrees between them
exactly, whatever order the sums are taken in.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import cuda_build

_EPS = 1e-12

METRIC_COLUMNS = ("area", "cumulative", "entropy", "gini")


def p_threshold(p_cdf: float) -> float:
    """The float32 value the CDF is compared against (``P - eps``, as the
    reference's float32 compare rounds it) — exactly representable, so a
    compare in float or double gives the same answer."""
    return float(np.float32(p_cdf - _EPS))


def skew_metrics_plain(scores_desc: torch.Tensor,
                       n_valid: Optional[torch.Tensor] = None,
                       p_cdf: float = 0.95) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: [B, K] -> [B, 4]."""
    s = scores_desc.to(torch.float32)
    b, k = s.shape
    if n_valid is None:
        nv = torch.full((b,), k, dtype=torch.int64, device=s.device)
    else:
        nv = n_valid.to(device=s.device, dtype=torch.int64).clamp(1, k)
    col = torch.arange(k, device=s.device)
    valid = col[None, :] < nv[:, None]
    hi = torch.where(valid, s, -torch.inf).amax(1, keepdim=True)
    lo = torch.where(valid, s, torch.inf).amin(1, keepdim=True)
    norm = torch.where(valid, (s - lo) / (hi - lo + _EPS), 0.0)
    area = norm.double().sum(1)
    shifted = torch.where(valid, s - lo.clamp(max=0.0), 0.0)
    denom = shifted.double().sum(1, keepdim=True).float() + _EPS
    prob = shifted / denom
    cdf = torch.cumsum(prob.double(), 1).float()
    below = (valid & (cdf < p_threshold(p_cdf))).sum(1)
    cum_k = torch.minimum(below + 1, nv)
    plogp = torch.where(prob > _EPS, prob * torch.log2(prob + _EPS), 0.0)
    entropy = -plogp.double().sum(1)
    weighted = ((col + 1).double()[None, :] * shifted.double()).sum(1)
    n1 = nv.double()
    gini = ((n1 + 1.0 - 2.0 * weighted / denom[:, 0].double()) / n1
            ).clamp(0.0, 1.0)
    return torch.stack([area, cum_k.double(), entropy, gini], 1).float()


def skew_metrics(scores_desc: torch.Tensor,
                 n_valid: Optional[torch.Tensor] = None,
                 p_cdf: float = 0.95) -> torch.Tensor:
    """[B, K] float32 descending (+ optional [B] int32 ``n_valid``) ->
    [B, 4] float32 (area, k@P, H, gini).

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream or raises."""
    if scores_desc.device.type == "cpu":
        return skew_metrics_plain(scores_desc, n_valid, p_cdf)
    dev = scores_desc.device
    if dev.type != "cuda" or scores_desc.dim() != 2:
        raise ValueError(f"skew_metrics takes a [B, K] CPU or CUDA tensor, "
                         f"got {tuple(scores_desc.shape)} on {dev}")
    b, k = scores_desc.shape
    cuda_build.check_tensor(scores_desc, "scores_desc", (b, k),
                            torch.float32, dev)
    if n_valid is not None:
        cuda_build.check_tensor(n_valid, "n_valid", (b,), torch.int32, dev)
    out = torch.empty((b, 4), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    cuda_build.launch(
        "skew_metrics", scores_desc.data_ptr(),
        None if n_valid is None else n_valid.data_ptr(), out.data_ptr(),
        b, k, p_threshold(p_cdf), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.LAUNCHES["skew_metrics"] += 1
    return out
