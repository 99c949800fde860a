"""Port parity: the fused triple scorer (its plain version on the CPU)
and the retrieval stage, against the JAX reference.

Weights are made by the reference and carried across with
`params_from_jax`; features come from the numpy KG synthesizer, whose
port is a copy and must produce identical arrays. The reference scorer
runs as its Pallas kernel in interpret mode (as its own suite runs it).
Tolerance 1e-5 (`tests/test_kernels.py`'s bar for the scorer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.triple_score import kernel as ref_kernel
from repro.retrieval import scorer as ref_sc
from repro.retrieval import synthetic as ref_syn
from repro_torch.kernels import cuda_build
from repro_torch.kernels.triple_score import kernel, ops
from repro_torch.retrieval import scorer as sc
from repro_torch.retrieval import synthetic

TOL = 1e-5


def make_args(rng, n, dt, dq, h, q, batched):
    feats = rng.normal(0, 1, (q, n, dt) if batched else (n, dt))
    return [x.astype(np.float32) for x in (
        feats, rng.normal(0, 1, (q, dq)), rng.normal(0, 0.2, (dt, h)),
        rng.normal(0, 0.2, (dq, h)), rng.normal(0, 0.1, (h,)),
        rng.normal(0, 0.2, (h, 1)), rng.normal(0, 1, (1,)))]


@pytest.mark.parametrize("n,dt,dq,h,q", [(128, 20, 8, 32, 1),
                                         (256, 36, 24, 64, 3),
                                         (512, 114, 32, 128, 2)])
def test_triple_score_matches_reference_kernel(n, dt, dq, h, q):
    args = make_args(np.random.default_rng(n), n, dt, dq, h, q, False)
    ref = ref_kernel.triple_score(*map(jnp.asarray, args), tile=64,
                                  interpret=True)
    port = ops.triple_score(*map(torch.as_tensor, args))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("b,n,dt,dq,h", [(4, 1, 20, 8, 32),
                                         (3, 129, 36, 24, 64),
                                         (2, 300, 110, 32, 128)])
def test_triple_score_batched_matches_reference_kernel(b, n, dt, dq, h):
    args = make_args(np.random.default_rng(b * n), n, dt, dq, h, b, True)
    ref = ref_kernel.triple_score_batched(*map(jnp.asarray, args),
                                          interpret=True)
    before = dict(cuda_build.LAUNCHES)
    port = ops.triple_score_batched(*map(torch.as_tensor, args))
    assert cuda_build.LAUNCHES == before  # CPU tensors never launch
    assert port.shape == (b, n)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        kernel.triple_score_batched_plain(*map(torch.as_tensor, args)),
        port.numpy(), rtol=0, atol=0)


def test_kernel_wrapper_rejects_non_cuda_devices():
    args = [torch.as_tensor(a, device="meta") for a in
            make_args(np.random.default_rng(0), 8, 4, 3, 5, 2, True)]
    with pytest.raises(ValueError):
        kernel.triple_score_batched(*args)


# -- retrieval ----------------------------------------------------------------

@pytest.fixture(scope="module")
def kgqa():
    """The synthetic CWQ-like benchmark from both packages (same seed)."""
    ref = ref_syn.make_dataset("cwq", n_queries=16, n_entities=600)
    port = synthetic.make_dataset("cwq", n_queries=16, n_entities=600)
    cfg = ref_sc.ScorerConfig(top_k=40)
    ref_params = ref_sc.init_scorer(jax.random.key(3), cfg)
    np_params = {k: np.asarray(v) for k, v in ref_params.items()}
    return ref, port, cfg, ref_params, np_params


def test_synthetic_dataset_copies_are_identical(kgqa):
    ref, port, _, _, _ = kgqa
    for name in ("heads", "rels", "tails", "order", "offsets"):
        np.testing.assert_array_equal(getattr(port.kg, name),
                                      getattr(ref.kg, name))
    np.testing.assert_array_equal(port.entity_emb, ref.entity_emb)
    assert [q.hops for q in port.queries] == [q.hops for q in ref.queries]
    rf, rq, re_, rn = ref_sc.batch_triple_features(
        ref.kg, ref.entity_emb, ref.relation_emb, ref.queries[:4],
        max_cands=64)
    pf, pq, pe, pn = sc.batch_triple_features(
        port.kg, port.entity_emb, port.relation_emb, port.queries[:4],
        max_cands=64)
    for a, b in ((rf, pf), (rq, pq), (re_, pe), (rn, pn)):
        np.testing.assert_array_equal(a, b)


def test_params_from_jax_and_scorer_shapes(kgqa):
    _, _, cfg, ref_params, np_params = kgqa
    params = sc.params_from_jax(np_params, device="cpu")
    assert set(params) == set(ref_params)
    for k, v in params.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np_params[k])
    mine = sc.init_scorer(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    for k, v in mine.items():
        assert tuple(v.shape) == ref_params[k].shape
    again = sc.init_scorer(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    assert [tuple(w.shape) for w in sc.kernel_weights(mine)] == \
        [tuple(w.shape) for w in ref_sc.kernel_weights(ref_params)]


def test_score_fn_matches_reference(kgqa):
    ref, port, cfg, ref_params, np_params = kgqa
    params = sc.params_from_jax(np_params, device="cpu")
    q = port.queries[0]
    edges = synthetic.candidate_edges(port.kg, q, max_edges=64)
    feats = sc.triple_features(port.kg, port.entity_emb, port.relation_emb,
                               q, edges)
    np.testing.assert_allclose(
        sc.score_fn(params, torch.as_tensor(feats),
                    torch.as_tensor(q.query_emb)).numpy(),
        np.asarray(ref_sc.score_fn(ref_params, jnp.asarray(feats),
                                   jnp.asarray(q.query_emb))),
        rtol=TOL, atol=TOL)


def test_retrieve_matches_reference(kgqa):
    ref, port, cfg, ref_params, np_params = kgqa
    params = sc.params_from_jax(np_params, device="cpu")
    for rq, pq in zip(ref.queries[:3], port.queries[:3]):
        r_edges, r_probs = ref_sc.retrieve(ref_params, ref.kg,
                                           ref.entity_emb, ref.relation_emb,
                                           rq, cfg, max_cands=96)
        p_edges, p_probs = sc.retrieve(params, port.kg, port.entity_emb,
                                       port.relation_emb, pq, cfg,
                                       max_cands=96)
        np.testing.assert_allclose(p_probs, r_probs, rtol=TOL, atol=TOL)
        distinct = np.abs(np.diff(r_probs, prepend=2.0, append=-1.0))
        keep = (distinct[:-1] > 1e-6) & (distinct[1:] > 1e-6)
        np.testing.assert_array_equal(p_edges[keep], r_edges[keep])


def test_retrieve_batch_matches_reference(kgqa):
    ref, port, cfg, ref_params, np_params = kgqa
    params = sc.params_from_jax(np_params, device="cpu")
    r_edges, r_probs, r_nv = ref_sc.retrieve_batch(
        ref_params, ref.kg, ref.entity_emb, ref.relation_emb,
        ref.queries[:5], cfg, max_cands=48, interpret=True)
    p_edges, p_probs, p_nv = sc.retrieve_batch(
        params, port.kg, port.entity_emb, port.relation_emb,
        port.queries[:5], cfg, max_cands=48)
    np.testing.assert_array_equal(p_nv, r_nv)
    np.testing.assert_allclose(p_probs, r_probs, rtol=TOL, atol=TOL)
    for i, nv in enumerate(r_nv):
        # edge ids only where the scores are not (near-)tied
        p = r_probs[i, :nv]
        gap = np.abs(np.diff(p, prepend=2.0, append=-1.0))
        keep = (gap[:-1] > 1e-6) & (gap[1:] > 1e-6)
        np.testing.assert_array_equal(p_edges[i, :nv][keep],
                                      r_edges[i, :nv][keep])
        assert (p_edges[i, nv:] == -1).all()
