"""Port parity of the `segment_reduce` kernel's plain version (what CPU
tensors take) and its public wrappers against the reference's Pallas
kernel in interpret mode, its oracle, its `ops.embedding_bag_fused` and
`models.recsys.embedding_bag`, on the CPU. fp32 at rtol = atol = 1e-5,
the reference's bar for this kernel (tests/test_kernels.py); bf16 sums
exactly as the plain fp32 sum rounded once to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import kernel as RK
from repro.kernels.segment_reduce import ops as ROPS
from repro.kernels.segment_reduce import ref as RREF
from repro.models import recsys as RR
from repro_torch.kernels.segment_reduce import kernel as K
from repro_torch.kernels.segment_reduce import ops as OPS
from repro_torch.kernels.segment_reduce import ref as REF
from repro_torch.models import recsys as R

TOL = dict(rtol=1e-5, atol=1e-5)


def close(port, ref, **tol):
    np.testing.assert_allclose(torch.as_tensor(port).numpy(), np.asarray(ref),
                               **(tol or TOL))


def seg_layout(b: int, nnz: int, pads: bool, seed: int):
    """Rows and sorted segment ids (``nnz`` per segment); with ``pads``
    some rows of every other segment, and one whole segment, are -1."""
    rng = np.random.default_rng(seed)
    seg = np.repeat(np.arange(b), nnz).astype(np.int32)
    if pads:
        seg[rng.random(b * nnz) < 0.3] = -1
        seg[:nnz] = -1                           # an all-pad segment
    return seg, rng


@pytest.mark.parametrize("b,nnz,d,tile,pads", [
    (8, 4, 16, 4, False), (16, 8, 32, 8, False), (32, 2, 64, 8, False),
    (8, 4, 1, 4, False), (16, 8, 10, 8, True), (8, 39, 21, 8, True)])
def test_segment_sum_plain_matches_reference_kernel(b, nnz, d, tile, pads):
    seg, rng = seg_layout(b, nnz, pads, seed=b * nnz + d)
    rows = rng.normal(0, 1, (b * nnz, d)).astype(np.float32)
    want = RK.segment_sum_sorted(jnp.asarray(rows), jnp.asarray(seg), b, nnz,
                                 seg_tile=tile, interpret=True)
    got = K.segment_sum_sorted(torch.from_numpy(rows), torch.from_numpy(seg),
                               b, nnz, seg_tile=tile)
    close(got, want)
    close(got, RREF.segment_sum_sorted_ref(jnp.asarray(rows),
                                           jnp.asarray(seg), b))
    close(REF.segment_sum_sorted_ref(torch.from_numpy(rows),
                                     torch.from_numpy(seg), b), want)
    close(OPS.segment_sum_sorted(rows, seg, b, nnz, seg_tile=tile), want)


def test_segment_sum_sorted_contract():
    """``N != S*r`` raises ValueError as in the reference; any segment
    count is taken (the reference's ``n_segments % seg_tile`` is a TPU
    grid rule); bf16 rows sum in fp32 and come back in bf16."""
    rows = torch.randn(10, 3)
    with pytest.raises(ValueError, match="n_segments"):
        K.segment_sum_sorted(rows, torch.zeros(10, dtype=torch.int32), 3, 4)
    with pytest.raises(ValueError, match="n_segments"):
        RK.segment_sum_sorted(jnp.zeros((10, 3)), jnp.zeros(10, jnp.int32),
                              3, 4, interpret=True)
    seg = torch.arange(5, dtype=torch.int32).repeat_interleave(2)
    got = K.segment_sum_sorted(rows, seg, 5, 2, seg_tile=8)
    with pytest.raises(ValueError, match="seg_tile"):
        RK.segment_sum_sorted(jnp.asarray(rows.numpy()), jnp.asarray(seg),
                              5, 2, seg_tile=8, interpret=True)
    close(got, REF.segment_sum_sorted_ref(rows, seg, 5))
    half = K.segment_sum_sorted(rows.bfloat16(), seg, 5, 2)
    assert half.dtype == torch.bfloat16
    close(half.float(), rows.bfloat16().float().view(5, 2, 3).sum(1).bfloat16()
          .float(), rtol=0, atol=0)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_fused_matches_reference(combiner):
    rng = np.random.default_rng(7)
    table = rng.normal(0, 1, (64, 8)).astype(np.float32)
    ids = rng.integers(-1, 64, (8, 5)).astype(np.int32)
    ids[3] = -1                                  # an all-pad bag
    got = OPS.embedding_bag_fused(torch.from_numpy(table),
                                  torch.from_numpy(ids), 8, combiner)
    close(got, ROPS.embedding_bag_fused(jnp.asarray(table), jnp.asarray(ids),
                                        8, combiner))
    close(got, RR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                combiner=combiner))
    close(R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          combiner=combiner), got, rtol=0, atol=0)
    assert not got[3].any()


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_id_past_the_table_is_nan(combiner, weighted):
    """An id past the table is gathered as a row of NaN and counted, as
    the reference's ``jnp.take`` (fill mode) makes it: its bag is NaN and
    every other bag is exact. The reference's Pallas wrapper spreads the
    NaN over its whole ``seg_tile`` (one-hot matmul, NaN * 0), so the
    oracle here is ``recsys.embedding_bag``."""
    rng = np.random.default_rng(11)
    table = rng.normal(0, 1, (30, 5)).astype(np.float32)
    ids = rng.integers(-1, 30, (6, 4)).astype(np.int32)
    ids[2, 1] = 30
    ids[4] = [-1, 45, -1, -1]
    w = rng.uniform(0.1, 2.0, (6, 4)).astype(np.float32) if weighted \
        else None
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          weights=None if w is None else torch.from_numpy(w),
                          combiner=combiner)
    want = RR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                            weights=None if w is None else jnp.asarray(w),
                            combiner=combiner)
    assert np.isnan(np.asarray(want)).any(axis=1).tolist() == \
        [False, False, True, False, True, False]
    np.testing.assert_array_equal(got.isnan().numpy(), np.isnan(want))
    close(got, want)                     # NaN where the reference has NaN
    if not weighted:
        close(K.embedding_bag_plain(torch.from_numpy(table),
                                    torch.from_numpy(ids),
                                    combiner == "mean"), got, rtol=0, atol=0)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_weighted_matches_reference(combiner):
    rng = np.random.default_rng(8)
    table = rng.normal(0, 1, (40, 6)).astype(np.float32)
    ids = rng.integers(-1, 40, (6, 4)).astype(np.int32)
    w = rng.uniform(0.1, 2.0, (6, 4)).astype(np.float32)
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          weights=torch.from_numpy(w), combiner=combiner)
    close(got, RR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                weights=jnp.asarray(w), combiner=combiner))
    with pytest.raises(ValueError, match="combiner"):
        R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        combiner="max")
