"""Sorted segment sum (the reduce of an embedding bag) and the embedding
bag itself — the recsys rankers' embedding engine.

Replaces the TPU kernel ``src/repro/kernels/segment_reduce/kernel.py``
(``segment_sum_sorted``, body ``_segsum_kernel``) and the gather of its
wrapper ``ops.embedding_bag_fused``. The CUDA source is
``repro_torch/kernels/csrc/segment_reduce.cu``: one kernel, two
launchers. :func:`segment_sum_sorted` is handed the rows; for
:func:`embedding_bag` the kernel gathers them from the table itself, so
the ``[S*r, D]`` rows never reach device memory. Bound by bytes: lanes
across D, bags across lanes, warps and blocks, each output one
sequential fp32 sum over its rows in order (no atomics, the same result
every run).

Contract, as the reference's: exactly ``rows_per_seg`` rows per segment,
segment ids sorted ascending, pad rows ``-1``. Segment ``s`` sums the rows
of its window ``[s*r, (s+1)*r)`` whose id is ``s``, which under the
contract is the oracle's function (``ref.segment_sum_sorted_ref``).
Unlike the Pallas kernel it takes any number of segments: ``seg_tile`` is
accepted for the signature and has no effect (the TPU kernel needs
``n_segments % seg_tile == 0`` for its grid).

A CUDA tensor launches the kernel on the current stream or raises; only a
CPU tensor takes the plain PyTorch version beside it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build

DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1


def _same_device(what: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, expected {dev}")


def _acc(x: torch.Tensor) -> torch.Tensor:
    """The kernel's accumulation type: fp32, or fp64 for fp64 input."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def _check_layout(n: int, n_segments: int, rows_per_seg: int) -> None:
    if n != n_segments * rows_per_seg:
        raise ValueError(f"N={n} != n_segments*rows_per_seg "
                         f"({n_segments}x{rows_per_seg})")


def segment_sum_sorted_plain(rows: torch.Tensor, seg_ids: torch.Tensor,
                             n_segments: int,
                             rows_per_seg: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``rows.view(S, r, D)``
    masked to each window's own rows, summed."""
    n, d = rows.shape
    _check_layout(n, n_segments, rows_per_seg)
    _same_device("seg_ids", seg_ids, rows.device)
    seg = seg_ids.reshape(n_segments, rows_per_seg)
    own = seg == torch.arange(n_segments, device=rows.device)[:, None]
    x = _acc(rows).reshape(n_segments, rows_per_seg, d)
    return torch.where(own[..., None], x, 0).sum(1).to(rows.dtype)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` by the reference's gather (``jnp.take``, fill mode):
    an id past the table gives a row of NaN; ids below 0 read row 0, for
    the caller to mask."""
    _same_device("ids", ids, table.device)
    inside = ids < table.shape[0]
    rows = table[torch.where(inside, ids, 0).clamp(min=0).long()]
    return torch.where(inside[..., None], rows, float("nan"))


def embedding_bag_plain(table: torch.Tensor, ids: torch.Tensor,
                        mean: bool = False) -> torch.Tensor:
    """The gathering launcher's function in plain PyTorch: ids ``[S, r]``
    (``-1`` pads) -> ``[S, D]`` sums, or means over the ids >= 0 (at least
    1). An id past the table makes its bag NaN, as in the reference."""
    valid = ids >= 0
    rows = _acc(take_rows(table, ids))
    out = torch.where(valid[..., None], rows, 0).sum(1)
    if mean:
        out = out / valid.sum(1, keepdim=True).clamp(min=1).to(out.dtype)
    return out.to(table.dtype)


def _check_float(what: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{what} must be 2-D, got {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CPU or CUDA tensor, got "
                         f"{t.device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{what}: the kernel takes {DTYPES}, got {t.dtype}")


def segment_sum_sorted(rows: torch.Tensor, seg_ids: torch.Tensor,
                       n_segments: int, rows_per_seg: int,
                       seg_tile: int = 8) -> torch.Tensor:
    """rows ``[S*r, D]`` fp32/bf16, seg_ids ``[S*r]`` int32 -> ``[S, D]``
    in ``rows.dtype`` (fp32 sums inside). ``seg_tile`` has no effect."""
    if rows.device.type == "cpu":
        return segment_sum_sorted_plain(rows, seg_ids, n_segments,
                                        rows_per_seg)
    _check_float("rows", rows)
    (n, d), dev = rows.shape, rows.device
    _check_layout(n, n_segments, rows_per_seg)
    cuda_build.check_tensor(rows, "rows", (n, d), rows.dtype, dev)
    cuda_build.check_tensor(seg_ids, "seg_ids", (n,), torch.int32, dev)
    if rows_per_seg > _INT32_MAX or d > _INT32_MAX:
        raise ValueError(f"rows_per_seg {rows_per_seg} and D {d} must fit "
                         f"in int32")
    out = torch.empty((n_segments, d), dtype=rows.dtype, device=dev)
    if out.numel() == 0:
        return out
    cuda_build.launch(
        "segment_sum_sorted", rows.data_ptr(), seg_ids.data_ptr(),
        out.data_ptr(), n_segments, rows_per_seg, d,
        int(rows.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.LAUNCHES["segment_sum_sorted"] += 1
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mean: bool = False) -> torch.Tensor:
    """table ``[V, D]`` fp32/bf16, ids ``[S, r]`` int32 (``-1`` pads) ->
    ``[S, D]`` in ``table.dtype``: each bag's rows gathered and summed in
    the kernel, divided by the count of ids >= 0 with ``mean``. An id past
    the table is not read; its bag is NaN, as in the reference."""
    if ids.dim() != 2:
        raise ValueError(f"ids must be [S, r], got {tuple(ids.shape)}")
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, mean)
    _check_float("table", table)
    dev = table.device
    (s, r), (v, d) = ids.shape, table.shape
    cuda_build.check_tensor(table, "table", (v, d), table.dtype, dev)
    cuda_build.check_tensor(ids, "ids", (s, r), torch.int32, dev)
    if v > _INT32_MAX + 1 or d > _INT32_MAX:
        raise ValueError(f"table rows {v} must be indexable by int32 ids")
    out = torch.empty((s, d), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    cuda_build.launch(
        "embedding_bag", table.data_ptr(), ids.data_ptr(), out.data_ptr(),
        s, r, d, v, int(mean), int(table.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.LAUNCHES["embedding_bag"] += 1
    return out
