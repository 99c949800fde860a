"""Port parity: the fused retrieve-to-decision path and calibration,
against the JAX reference.

`route_retrieved` runs both ways in both packages (the fused kernels —
the reference's in Pallas interpret mode, the port's as their plain
versions on the CPU — and the oracle ops), and against the port's own
host-staged reference. Tiers must be equal; metrics, difficulty and
probabilities agree to 1e-5; candidate indices are compared only where
the scores differ, since `jax.lax.top_k` and `torch.topk` may order ties
differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibrate as ref_cal
from repro.core import router as ref_router
from repro.core import streaming_calibrate as ref_stream
from repro_torch.core import calibrate, router, streaming_calibrate
from repro_torch.retrieval import scorer as sc

TOL = 1e-5
DT, DQ, H = 12, 8, 16


def make_params(rng):
    return {
        "w1_t": rng.normal(0, 0.3, (DT, H)).astype(np.float32),
        "w1_q": rng.normal(0, 0.3, (DQ, H)).astype(np.float32),
        "b1": rng.normal(0, 0.1, (H,)).astype(np.float32),
        "w2": rng.normal(0, 0.3, (H, 1)).astype(np.float32),
        "b2": rng.normal(0, 0.1, (1,)).astype(np.float32),
    }


def assert_same_route(port, ref, feats_logits=None):
    np.testing.assert_array_equal(np.asarray(port.tiers),
                                  np.asarray(ref.tiers))
    np.testing.assert_array_equal(np.asarray(port.n_valid),
                                  np.asarray(ref.n_valid))
    np.testing.assert_array_equal(np.asarray(port.metrics)[:, 1],
                                  np.asarray(ref.metrics)[:, 1])
    for name in ("metrics", "difficulty", "probs"):
        np.testing.assert_allclose(np.asarray(getattr(port, name)),
                                   np.asarray(getattr(ref, name)),
                                   atol=TOL, rtol=TOL, err_msg=name)
    p_idx, r_idx = np.asarray(port.indices), np.asarray(ref.indices)
    probs = np.asarray(ref.probs)
    for i, nv in enumerate(np.asarray(ref.n_valid)):
        gap = np.abs(np.diff(probs[i, :nv], prepend=2.0, append=-1.0))
        distinct = (gap[:-1] > 1e-6) & (gap[1:] > 1e-6)
        np.testing.assert_array_equal(p_idx[i, :nv][distinct],
                                      r_idx[i, :nv][distinct])


@pytest.mark.parametrize("metric", ["area", "cumulative", "entropy", "gini"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_route_retrieved_matches_reference(metric, use_kernels):
    rng = np.random.default_rng(17)
    b, n, k = 8, 90, 37                 # ragged, K not a tile multiple
    feats = rng.normal(0, 1, (b, n, DT)).astype(np.float32)
    qemb = rng.normal(0, 1, (b, DQ)).astype(np.float32)
    n_cand = rng.integers(20, n + 1, b).astype(np.int32)
    params = make_params(rng)
    staged_cfg = router.RouterConfig(metric=metric, thresholds=(0.0,),
                                     top_k=k)
    d = router.route_retrieved_staged(feats, qemb, params, staged_cfg,
                                      n_cand=n_cand).difficulty.numpy()
    cfg = dict(metric=metric, thresholds=(float(np.median(d)) + 1e-3,),
               top_k=k)
    ref = ref_router.route_retrieved(
        jnp.asarray(feats), jnp.asarray(qemb),
        {k_: jnp.asarray(v) for k_, v in params.items()},
        ref_router.RouterConfig(**cfg), n_cand=jnp.asarray(n_cand),
        interpret=True, use_kernels=use_kernels)
    t_params = sc.params_from_jax(params, device="cpu")
    port = router.route_retrieved(
        torch.as_tensor(feats), torch.as_tensor(qemb), t_params,
        router.RouterConfig(**cfg), n_cand=torch.as_tensor(n_cand),
        use_kernels=use_kernels)
    assert_same_route(port, ref)
    staged = router.route_retrieved_staged(
        feats, qemb, t_params, router.RouterConfig(**cfg), n_cand=n_cand)
    assert_same_route(port, staged)
    assert 0 < int(port.tiers.sum()) < b      # the threshold splits the batch


def test_route_retrieved_dense_matches_reference():
    """No n_cand (every candidate real) and N below top_k."""
    rng = np.random.default_rng(2)
    feats = rng.normal(0, 1, (3, 20, DT)).astype(np.float32)
    qemb = rng.normal(0, 1, (3, DQ)).astype(np.float32)
    params = make_params(rng)
    cfg = dict(metric="entropy", thresholds=(4.0,), top_k=100)
    ref = ref_router.route_retrieved(
        jnp.asarray(feats), jnp.asarray(qemb),
        {k: jnp.asarray(v) for k, v in params.items()},
        ref_router.RouterConfig(**cfg), interpret=True)
    port = router.route_retrieved(
        torch.as_tensor(feats), torch.as_tensor(qemb),
        sc.params_from_jax(params, device="cpu"),
        router.RouterConfig(**cfg))
    assert port.probs.shape == (3, 20)
    assert_same_route(port, ref)


@pytest.mark.parametrize("metric", ["area", "cumulative", "entropy", "gini"])
def test_calibrate_threshold_matches_reference(metric):
    rng = np.random.default_rng(4)
    scores = np.sort(rng.uniform(0.01, 1, (100, 60)).astype(np.float32) **
                     rng.uniform(0.5, 6, (100, 1)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    nv = rng.integers(5, 61, 100)
    mask = np.arange(60)[None, :] < nv[:, None]
    for rho in (0.0, 0.3, 0.5, 1.0):
        port = calibrate.calibrate_threshold(torch.as_tensor(scores), rho,
                                             metric,
                                             mask=torch.as_tensor(mask))
        ref = ref_cal.calibrate_threshold(jnp.asarray(scores), rho, metric,
                                          mask=jnp.asarray(mask))
        assert port == pytest.approx(ref, abs=TOL, rel=TOL)
    port_cfg = calibrate.calibrate_multi_tier(scores, (0.5, 0.3, 0.2), metric)
    ref_cfg = ref_cal.calibrate_multi_tier(jnp.asarray(scores),
                                           (0.5, 0.3, 0.2), metric)
    np.testing.assert_allclose(port_cfg.thresholds, ref_cfg.thresholds,
                               atol=TOL, rtol=TOL)
    assert (port_cfg.metric, port_cfg.top_k) == (ref_cfg.metric,
                                                  ref_cfg.top_k)


def test_sweep_curves_match_reference():
    rng = np.random.default_rng(9)
    diff, qs, ql = (rng.normal(0, 1, 200), rng.integers(0, 2, 200),
                    rng.integers(0, 2, 200))
    cs, cl = np.full(200, 1.0), np.full(200, 4.0)
    assert calibrate.sweep_thresholds(torch.as_tensor(diff), qs, ql, cs,
                                      cl) == [
        calibrate.SweepPoint(**vars(p)) for p in
        ref_cal.sweep_thresholds(diff, qs, ql, cs, cl)]
    for port_fn, ref_fn in ((calibrate.oracle_curve, ref_cal.oracle_curve),
                            (calibrate.random_mix_curve,
                             ref_cal.random_mix_curve)):
        port = [(p.large_call_ratio, p.quality, p.cost)
                for p in port_fn(qs, ql, cs, cl)]
        ref = [(p.large_call_ratio, p.quality, p.cost)
               for p in ref_fn(qs, ql, cs, cl)]
        assert port == ref


def test_streaming_calibrator_state_crosses_packages():
    """Same difficulty stream -> same swaps; the state dict of one
    package loads in the other."""
    rng = np.random.default_rng(1)
    cfgs = (router.RouterConfig(metric="entropy", thresholds=(5.0,)),
            ref_router.RouterConfig(metric="entropy", thresholds=(5.0,)))
    port = streaming_calibrate.StreamingCalibrator(cfgs[0], (0.7, 0.3),
                                                   window=64, min_samples=16)
    ref = ref_stream.StreamingCalibrator(cfgs[1], (0.7, 0.3), window=64,
                                         min_samples=16)
    for _ in range(6):
        batch = rng.normal(5.5, 0.3, 24).astype(np.float32)
        a, b = port.observe(batch), ref.observe(batch)
        assert (a is None) == (b is None)
    assert port.config.thresholds == ref.config.thresholds
    assert port.n_swaps == ref.n_swaps > 0
    fresh = ref_stream.StreamingCalibrator(cfgs[1], (0.7, 0.3), window=64,
                                           min_samples=16)
    fresh.load_state_dict(port.state_dict())
    assert fresh.state_dict() == ref.state_dict()
