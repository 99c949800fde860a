"""Oracle: an index-add segment sum over the same layout."""

from __future__ import annotations

import torch


def segment_sum_sorted_ref(rows, seg_ids, n_segments, rows_per_seg=None):
    """Pad rows (``seg_id < 0``) go to a dummy segment ``n_segments``,
    which is dropped: ``index_add_`` into ``n_segments + 1`` rows."""
    rows = torch.as_tensor(rows)
    seg = torch.as_tensor(seg_ids, device=rows.device).reshape(-1).long()
    safe = torch.where(seg >= 0, seg, n_segments)
    out = torch.zeros((n_segments + 1,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, safe, rows)[:n_segments]
