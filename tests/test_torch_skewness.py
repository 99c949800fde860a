"""Port parity: skew metrics, the fused skew-metrics kernel's plain
version, and the decision program, against the JAX reference.

Inputs are made with numpy seeds and handed to both packages. The
reference runs its oracle (`repro.core.skewness`) and its Pallas kernel
in interpret mode, as its own suite does. Tolerance: atol 1e-5 with rtol
1e-5 on every metric column (sums of up to K float32 terms taken in
another order); cumulative-k, an integer count, must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as ref_router
from repro.core import skewness as ref_sk
from repro.kernels.skew_metrics import ops as ref_ops
from repro_torch.core import router, skewness as sk
from repro_torch.kernels import cuda_build
from repro_torch.kernels.skew_metrics import kernel, ops

ATOL = RTOL = 1e-5

# value=5.64e-34, k=2: the near-zero total Hypothesis recorded for the
# reference's constant-vector test (area 0, cumulative-k 2, entropy 0,
# gini 1 in both of the reference's implementations)
TINY = 5.6406751573846435e-34


def desc_scores(rng, b, k, lo=0.01, hi=1.0):
    return np.sort(rng.uniform(lo, hi, (b, k)).astype(np.float32),
                   axis=1)[:, ::-1].copy()


def assert_metrics(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port[:, 1], ref[:, 1])      # cumulative-k
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=RTOL)


def ref_kernel(scores, n_valid=None, p_cdf=0.95):
    nv = None if n_valid is None else jnp.asarray(n_valid, jnp.int32)
    return np.asarray(ref_ops.skew_metrics(jnp.asarray(scores), p_cdf=p_cdf,
                                           n_valid=nv, interpret=True))


def port_kernel(scores, n_valid=None, p_cdf=0.95):
    nv = None if n_valid is None else torch.as_tensor(n_valid)
    return ops.skew_metrics(torch.as_tensor(scores), p_cdf=p_cdf,
                            n_valid=nv).numpy()


# -- the oracle metrics -------------------------------------------------------

@pytest.mark.parametrize("b,k,seed,lo,hi,ragged", [
    (6, 100, 0, 0.01, 1.0, False),
    (9, 37, 1, -0.5, 1.0, True),        # logits with negatives, ragged
    (4, 200, 2, -3.0, 3.0, True),
    (5, 1, 3, 0.0, 1.0, False),
])
def test_oracle_metrics_match_reference(b, k, seed, lo, hi, ragged):
    rng = np.random.default_rng(seed)
    scores = desc_scores(rng, b, k, lo, hi)
    mask = None
    if ragged:
        nv = rng.integers(1, k + 1, b)
        mask = np.arange(k)[None, :] < nv[:, None]
    t_mask = None if mask is None else torch.as_tensor(mask)
    j_mask = None if mask is None else jnp.asarray(mask)
    s_t, s_j = torch.as_tensor(scores), jnp.asarray(scores)
    for name in ("normalize_minmax", "normalize_prob", "area_metric",
                 "entropy_metric", "gini_metric"):
        np.testing.assert_allclose(
            getattr(sk, name)(s_t, t_mask).numpy(),
            np.asarray(getattr(ref_sk, name)(s_j, j_mask)),
            atol=ATOL, rtol=RTOL, err_msg=name)
    np.testing.assert_array_equal(sk.cumulative_k(s_t, 0.9, t_mask).numpy(),
                                  np.asarray(ref_sk.cumulative_k(s_j, 0.9,
                                                                 j_mask)))
    for metric in sk.METRICS:
        np.testing.assert_allclose(
            sk.difficulty(s_t, metric, 0.9, t_mask).numpy(),
            np.asarray(ref_sk.difficulty(s_j, metric, 0.9, j_mask)),
            atol=ATOL, rtol=RTOL, err_msg=metric)
    port_all = sk.all_metrics(s_t, mask=t_mask)
    ref_all = ref_sk.all_metrics(s_j, mask=j_mask)
    assert port_all.keys() == ref_all.keys()


@pytest.mark.parametrize("value", [TINY, 0.0, 0.7, -1.3])
@pytest.mark.parametrize("k", [2, 37, 128])
def test_constant_rows_match_reference(value, k):
    """Degenerate normalizations: both the oracle and the kernel's plain
    version agree with the reference's own two implementations."""
    scores = np.full((3, k), np.float32(value))
    s_t, s_j = torch.as_tensor(scores), jnp.asarray(scores)
    assert_metrics(ops.skew_metrics_ref(s_t).numpy(),
                   np.asarray(ref_ops.skew_metrics_ref(s_j)))
    assert_metrics(port_kernel(scores), ref_kernel(scores))


def test_near_zero_total_matches_reference_values():
    """The recorded Hypothesis example: the reference reports area 0,
    cumulative-k 2, entropy 0 and Gini 1; so does the port."""
    out = port_kernel(np.full((1, 2), np.float32(TINY)))
    np.testing.assert_array_equal(out[0], [0.0, 2.0, 0.0, 1.0])
    np.testing.assert_array_equal(ops.skew_metrics_ref(
        torch.full((1, 2), TINY)).numpy()[0], [0.0, 2.0, 0.0, 1.0])


# -- the fused kernel's plain version vs the reference Pallas kernel ----------

@pytest.mark.parametrize("b,k,seed,p_cdf", [
    (16, 1, 0, 0.95),
    (24, 37, 1, 0.95),
    (32, 100, 2, 0.9),
    (8, 200, 3, 0.95),
])
@pytest.mark.parametrize("ragged", [False, True])
def test_kernel_plain_matches_reference_kernel(b, k, seed, p_cdf, ragged):
    rng = np.random.default_rng(seed)
    scores = desc_scores(rng, b, k, -0.5 if ragged else 0.01, 1.0)
    n_valid = None
    if ragged:   # includes the clamped edge cases 0 and 1
        n_valid = rng.integers(0, k + 1, b).astype(np.int32)
        n_valid[:2] = [0, 1]
    before = dict(cuda_build.LAUNCHES)
    assert_metrics(port_kernel(scores, n_valid, p_cdf),
                   ref_kernel(scores, n_valid, p_cdf))
    assert cuda_build.LAUNCHES == before  # CPU tensors never launch


def test_kernel_plain_matches_oracle_on_valid_rows():
    """n_valid >= 1 rows: the kernel's arithmetic == the port's oracle."""
    rng = np.random.default_rng(7)
    scores = desc_scores(rng, 12, 50, -1.0, 1.0)
    nv = rng.integers(1, 51, 12).astype(np.int32)
    s = torch.as_tensor(scores)
    mask = ops.mask_from_n_valid(torch.as_tensor(nv), 50)
    assert_metrics(kernel.skew_metrics(s, torch.as_tensor(nv)).numpy(),
                   ops.skew_metrics_ref(s, mask=mask).numpy())


def test_kernel_wrapper_checks_its_inputs():
    s = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        kernel.skew_metrics(torch.zeros(4, 8, device="meta"))
    assert kernel.skew_metrics(s).shape == (4, 4)
    assert kernel.p_threshold(0.95) == np.float32(0.95)


# -- the decision program -----------------------------------------------------

@pytest.mark.parametrize("metric", ["area", "cumulative", "entropy", "gini"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_route_all_metrics_matches_reference(metric, use_kernel):
    rng = np.random.default_rng(11)
    scores = desc_scores(rng, 64, 100, -0.2, 1.0)
    nv = rng.integers(1, 101, 64).astype(np.int32)
    j_all = ref_sk.all_metrics(jnp.asarray(scores))
    d = np.asarray(j_all[metric])
    cfg = dict(metric=metric, thresholds=tuple(np.quantile(d, [0.3, 0.7])
                                               + 1e-3))
    port = router.route_all_metrics(torch.as_tensor(scores),
                                    router.RouterConfig(**cfg),
                                    n_valid=torch.as_tensor(nv),
                                    use_kernel=use_kernel)
    ref = ref_router.route_all_metrics(jnp.asarray(scores),
                                       ref_router.RouterConfig(**cfg),
                                       n_valid=jnp.asarray(nv),
                                       interpret=True, use_kernel=use_kernel)
    np.testing.assert_array_equal(port.tiers.numpy(), np.asarray(ref.tiers))
    assert port.tiers.dtype == torch.int32
    assert_metrics(port.metrics.numpy(), np.asarray(ref.metrics))
    np.testing.assert_allclose(port.difficulty.numpy(),
                               np.asarray(ref.difficulty), atol=ATOL,
                               rtol=RTOL)


def test_route_helpers_match_reference():
    rng = np.random.default_rng(5)
    scores = desc_scores(rng, 32, 20)
    for metric in ("area", "gini"):
        cfg = dict(metric=metric, thresholds=(-0.5, 5.0, 9.0))
        s_t, s_j = torch.as_tensor(scores), jnp.asarray(scores)
        np.testing.assert_array_equal(
            router.route(s_t, router.RouterConfig(**cfg)).numpy(),
            np.asarray(ref_router.route(s_j, ref_router.RouterConfig(**cfg))))
        np.testing.assert_array_equal(
            router.route_binary(s_t, router.RouterConfig(**cfg)).numpy(),
            np.asarray(ref_router.route_binary(
                s_j, ref_router.RouterConfig(**cfg))))
    diff = rng.normal(0, 1, 50).astype(np.float32)
    cuts, opts = np.asarray([-0.5, 0.5], np.float32), np.asarray([25, 50, 100])
    np.testing.assert_array_equal(
        router.select_depths(torch.as_tensor(diff), torch.as_tensor(cuts),
                             torch.as_tensor(opts)).numpy(),
        np.asarray(ref_router.select_depths(jnp.asarray(diff),
                                            jnp.asarray(cuts),
                                            jnp.asarray(opts))))
    assert router.expected_tier_shares(torch.as_tensor(diff), (0.0,)) == \
        ref_router.expected_tier_shares(jnp.asarray(diff), (0.0,))
    tiers = (diff > 0).astype(np.int32)
    port_stats = router.RoutingStats.from_assignments(
        torch.as_tensor(tiers), 2, torch.as_tensor(diff))
    ref_stats = ref_router.RoutingStats.from_assignments(
        jnp.asarray(tiers), 2, jnp.asarray(diff))
    assert port_stats.tier_counts == ref_stats.tier_counts
    assert port_stats.large_call_ratio == ref_stats.large_call_ratio
    assert port_stats.mean_difficulty == pytest.approx(
        ref_stats.mean_difficulty, abs=1e-6)
    with pytest.raises(ValueError):
        router.RouterConfig(thresholds=(1.0, 0.0))
    with pytest.raises(ValueError):
        router.difficulty_from_metrics(torch.zeros(2, 4), "nope")
