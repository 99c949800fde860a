"""Public wrappers with the reference's signatures: embedding-bag style
sorted segment sum, and the embedding bag on top of it.

They run where their inputs live: the CUDA kernel for CUDA tensors, the
kernel's plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce import kernel, ref


def segment_sum_sorted(rows, seg_ids, n_segments, rows_per_seg,
                       seg_tile: int = 8):
    """rows [S*r, D]; seg_ids [S*r] sorted, exactly ``rows_per_seg`` rows
    per segment (pad rows -1, dropped) -> [S, D] sums."""
    rows = torch.as_tensor(rows)
    seg = torch.as_tensor(seg_ids, device=rows.device).reshape(-1).to(
        torch.int32)
    return kernel.segment_sum_sorted(rows.contiguous(), seg.contiguous(),
                                     n_segments, rows_per_seg,
                                     seg_tile=seg_tile)


def embedding_bag_fused(table, ids, n_bags, combiner: str = "sum"):
    """EmbeddingBag: ids [B, nnz] (-1 pad) -> [B, dim]. The gather and the
    reduce are one kernel launch; ``mean`` divides by the number of
    non-pad ids (at least 1)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    table = torch.as_tensor(table)
    ids = torch.as_tensor(ids, device=table.device)
    if ids.dim() != 2 or ids.shape[0] != n_bags:
        raise ValueError(f"ids must be [n_bags={n_bags}, nnz], got "
                         f"{tuple(ids.shape)}")
    ids = ids.to(torch.int32).contiguous()
    mean = combiner == "mean"
    return kernel.embedding_bag(table.contiguous(), ids, mean)


segment_sum_sorted_ref = ref.segment_sum_sorted_ref
