"""Port parity: the `RouteSpec` -> `build` -> `SkewRouteSession` surface
against the JAX reference, on the CPU (``device="cpu"``).

One session per backend name in each package, fed the same batches:
tiers must be equal, and after the streaming calibrator's hot-swaps the
thresholds and telemetry must agree. Specs and snapshot envelopes cross
between the packages in both directions.
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro_torch.api as api
from repro.serving import _deprecation as ref_deprecation
from repro_torch.kernels import resolve_device
from repro_torch.retrieval import scorer as sc
from repro_torch.serving import _deprecation

TOL = 1e-5
BACKENDS = ("oracle", "pallas", "fused", "auto")
DT, DQ, H = 12, 8, 16


def spec_dict(backend="auto", **overrides):
    d = dict(metric="entropy", thresholds=(5.2,), top_k=50,
             tier_names=("qwen7b", "qwen72b"), backend=backend,
             crossover_batch=16,
             calibration=dict(policy="streaming", target_shares=(0.7, 0.3),
                              window=128, min_samples=32, tolerance=0.05,
                              cooldown=32))
    d.update(overrides)
    return d


def both_specs(backend="auto", **overrides):
    payload = json.dumps(spec_dict(backend, **overrides))
    return api.RouteSpec.from_json(payload), ref_api.RouteSpec.from_json(
        payload)


def batches(seed=0, sizes=(40, 8, 64, 24)):
    rng = np.random.default_rng(seed)
    out = []
    for b in sizes:
        # power-law rows with varied decay: a spread of entropies
        alpha = rng.uniform(0.05, 1.5, (b, 1))
        s = (1.0 / np.arange(1, 51) ** alpha).astype(np.float32)
        s *= rng.uniform(0.9, 1.0, (b, 50)).astype(np.float32)
        s = -np.sort(-s, axis=1)
        out.append((s, rng.integers(10, 51, b).astype(np.int32)))
    return out


def telemetry_close(port, ref):
    assert port.keys() == ref.keys()
    for key, value in ref.items():
        if key == "thresholds":
            np.testing.assert_allclose(port[key], value, atol=TOL, rtol=TOL)
        elif key in ("mean_difficulty", "total_cost", "large_call_ratio"):
            assert port[key] == pytest.approx(value, abs=TOL, rel=TOL), key
        else:
            assert port[key] == value, key


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_per_backend_matches_reference(backend):
    port_spec, ref_spec = both_specs(backend)
    assert port_spec.to_dict() == ref_spec.to_dict()
    assert api.policy_fingerprint(port_spec) == \
        ref_api.policy_fingerprint(ref_spec)
    port, ref = api.build(port_spec, device="cpu"), ref_api.build(ref_spec)
    for scores, nv in batches():
        p = port.route(scores, n_valid=nv)
        r = ref.route(scores, n_valid=nv)
        np.testing.assert_array_equal(p.tiers, r.tiers)
        np.testing.assert_allclose(p.metrics, r.metrics, atol=TOL, rtol=TOL)
        assert p.first_id == r.first_id and p.recalibrated == r.recalibrated
    assert port.stats.n_recalibrations >= 1
    np.testing.assert_allclose(port.thresholds, ref.thresholds, atol=TOL,
                               rtol=TOL)
    telemetry_close(port.telemetry(), ref.telemetry())
    rec_p, rec_r = port.route_one(batches(5)[0][0][0]), \
        ref.route_one(batches(5)[0][0][0])
    assert (rec_p.tier, rec_p.request_id) == (rec_r.tier, rec_r.request_id)


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_route_retrieved_per_backend(backend):
    rng = np.random.default_rng(3)
    params = {"w1_t": rng.normal(0, 0.3, (DT, H)),
              "w1_q": rng.normal(0, 0.3, (DQ, H)),
              "b1": rng.normal(0, 0.1, (H,)),
              "w2": rng.normal(0, 0.3, (H, 1)),
              "b2": rng.normal(0, 0.1, (1,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    port_spec, ref_spec = both_specs(backend, metric="gini",
                                     thresholds=(-0.05,), top_k=30)
    port, ref = api.build(port_spec, device="cpu"), ref_api.build(ref_spec)
    for b in (5, 20):
        feats = rng.normal(0, 1, (b, 64, DT)).astype(np.float32)
        qemb = rng.normal(0, 1, (b, DQ)).astype(np.float32)
        n_cand = rng.integers(10, 65, b).astype(np.int32)
        p = port.route_retrieved(feats, qemb,
                                 sc.params_from_jax(params, device="cpu"),
                                 n_cand=n_cand)
        r = ref.route_retrieved(feats, qemb,
                                {k: jnp.asarray(v) for k, v in params.items()},
                                n_cand=n_cand)
        np.testing.assert_array_equal(p.tiers, r.tiers)
        np.testing.assert_array_equal(p.n_valid, r.n_valid)
        np.testing.assert_allclose(p.probs, r.probs, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(p.result.metrics, r.result.metrics,
                                   atol=TOL, rtol=TOL)
    telemetry_close(port.telemetry(), ref.telemetry())


def test_reference_spec_json_builds_with_same_fingerprint():
    ref_spec = ref_api.RouteSpec(
        metric="gini", thresholds=(-0.4, -0.2),
        tier_names=("qwen7b", "qwen14b", "qwen72b"),
        calibration=ref_api.CalibrationSpec(policy="streaming",
                                            target_shares=(0.5, 0.3, 0.2)),
        cost=ref_api.CostSpec(n_triples=50),
        admission=ref_api.AdmissionSpec(cost_budget_per_query=1e-4),
        policy=ref_api.ThresholdPolicySpec())
    port_spec = api.RouteSpec.from_json(ref_spec.to_json())
    assert port_spec.to_json() == ref_spec.to_json()
    assert api.policy_fingerprint(port_spec) == \
        ref_api.policy_fingerprint(ref_spec)
    assert ref_api.RouteSpec.from_json(port_spec.to_json()) == ref_spec
    assert api.DEFAULT_CROSSOVER_BATCH == ref_api.DEFAULT_CROSSOVER_BATCH
    assert api.available_backends() == ref_api.available_backends()


def test_sharded_is_known_but_not_built_yet():
    spec, _ = both_specs("sharded")
    assert spec.backend == "sharded"
    with pytest.raises(NotImplementedError):
        api.build(spec, device="cpu")
    with pytest.raises(ValueError):
        api.make_backend("nope")


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snapshot_envelope_crosses_packages(direction):
    port_spec, ref_spec = both_specs("oracle")
    port, ref = api.build(port_spec, device="cpu"), ref_api.build(ref_spec)
    for scores, nv in batches(7):
        port.route(scores, n_valid=nv)
        ref.route(scores, n_valid=nv)
    src, dst_cls = ((ref, lambda s: api.SkewRouteSession.from_snapshot(
        s, device="cpu")) if direction == "ref_to_port"
        else (port, ref_api.SkewRouteSession.from_snapshot))
    snap = json.loads(json.dumps(src.snapshot()))
    assert snap["envelope_version"] == api.ENVELOPE_VERSION == 2
    restored = dst_cls(snap)
    assert restored.thresholds == src.thresholds
    assert restored.snapshot() == snap
    # the restored replica routes the next batch like the donor
    scores, nv = batches(8, sizes=(16,))[0]
    np.testing.assert_array_equal(restored.route(scores, n_valid=nv).tiers,
                                  src.route(scores, n_valid=nv).tiers)


def test_submit_flush_with_fake_runners_matches_reference():
    port_spec, ref_spec = both_specs("auto", micro_batch=4)
    ran = {"port": [], "ref": []}

    def runners(key):
        return {t: (lambda batch, t=t: ran[key].append((t, list(batch))))
                for t in range(2)}

    port = api.build(port_spec, runners=runners("port"), device="cpu")
    ref = ref_api.build(ref_spec, runners=runners("ref"))
    for i, (scores, nv) in enumerate(batches(11, sizes=(10, 7, 33))):
        payloads = [f"req{i}-{j}" for j in range(len(scores))]
        p = port.submit(scores, payloads, n_valid=nv)
        r = ref.submit(scores, payloads, n_valid=nv)
        np.testing.assert_array_equal(p.tiers, r.tiers)
    assert port.flush() == ref.flush() > 0
    assert ran["port"] == ran["ref"]
    assert [(b.tier, b.size) for b in port.executed] == \
        [(b.tier, b.size) for b in ref.executed]
    telemetry_close(port.telemetry(), ref.telemetry())
    with pytest.raises(RuntimeError):
        api.build(port_spec, device="cpu").submit(batches()[0][0])


def test_session_accepts_tensors_and_admission_matches_reference():
    port_spec, ref_spec = both_specs(
        "auto", admission=dict(cost_budget_per_query=2e-4,
                               control_interval=8))
    runners = {0: len, 1: len}
    port = api.build(port_spec, runners=runners, device="cpu")
    ref = ref_api.build(ref_spec, runners=runners)
    for scores, nv in batches(13):
        port.observe_tier_load(1, 12, p99_latency=float("nan"))
        ref.observe_tier_load(1, 12, p99_latency=float("nan"))
        p = port.submit(torch.as_tensor(scores), n_valid=nv)
        r = ref.submit(scores, n_valid=nv)
        np.testing.assert_array_equal(p.tiers, r.tiers)
    port.flush(), ref.flush()
    telemetry_close(port.telemetry()["pipeline"], ref.telemetry()["pipeline"])
    assert port.snapshot()["state"]["admission"].keys() == \
        ref.snapshot()["state"]["admission"].keys()


def test_device_is_runtime_not_policy():
    spec, _ = both_specs()
    session = api.build(spec, device="cpu")
    assert "device" not in json.dumps(session.snapshot())
    assert session.backend.effective_device() == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:   # CUDA by default, and no silent fallback to the CPU
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            api.build(spec)
    assert resolve_device("cpu") == torch.device("cpu")


def test_old_constructors_warn_once_in_the_port():
    from repro_torch.core.router import RouterConfig
    from repro_torch.serving import SkewRouteDispatcher
    _deprecation.reset()
    ref_deprecation.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            SkewRouteDispatcher(RouterConfig(), ("a", "b"), device="cpu")
    assert sum(issubclass(w.category, DeprecationWarning)
               for w in caught) == 1


def json_close(port, ref, where="$"):
    """Equal structure and values; floats within TOL."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and port.keys() == ref.keys(), where
        for k in ref:
            json_close(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            json_close(a, b, f"{where}[{i}]")
    elif isinstance(ref, float):
        assert port == pytest.approx(ref, abs=TOL, rel=TOL), where
    else:
        assert port == ref, where


def test_observability_plane_matches_reference():
    """Both packages with the plane on under the same seeded ManualClock
    and the same traffic: the JSONL event log holds the same events, ids
    and tiers in the same order, and the Prometheus text the same
    samples; floats (difficulties, thresholds) agree within TOL."""
    from repro.obs import ManualClock as RefClock, Observability as RefObs
    from repro_torch.obs import ManualClock, Observability
    port_spec, ref_spec = both_specs("auto", micro_batch=4)
    runners = {0: len, 1: len}
    port = api.build(port_spec, runners=runners, device="cpu",
                     obs=Observability(clock=ManualClock(start=1.0,
                                                         step=0.5)))
    ref = ref_api.build(ref_spec, runners=runners,
                        obs=RefObs(clock=RefClock(start=1.0, step=0.5)))
    for scores, nv in batches(17):
        port.submit(scores, n_valid=nv)
        ref.submit(scores, n_valid=nv)
    port.flush(), ref.flush()
    p_lines = port.obs.jsonl().splitlines()
    r_lines = ref.obs.jsonl().splitlines()
    assert len(p_lines) == len(r_lines) > 0
    for a, b in zip(p_lines, r_lines):
        json_close(json.loads(a), json.loads(b))
    p_prom = port.obs.prometheus().splitlines()
    r_prom = ref.obs.prometheus().splitlines()
    assert len(p_prom) == len(r_prom) > 0
    for a, b in zip(p_prom, r_prom):
        if b.startswith("#"):
            assert a == b
        else:
            (ka, va), (kb, vb) = a.rsplit(" ", 1), b.rsplit(" ", 1)
            assert ka == kb
            assert float(va) == pytest.approx(float(vb), abs=TOL, rel=TOL)
    json_close(json.loads(json.dumps(port.snapshot()["state"]["obs"])),
               json.loads(json.dumps(ref.snapshot()["state"]["obs"])))
