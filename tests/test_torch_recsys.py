"""Port parity of the recsys routing path against the reference, on the
CPU: `repro_torch.models.recsys` (the four rankers' forward, user
embedding, retrieval scores) with the reference's weights carried across
by `params_from_jax`, and the recsys routing example against the
reference example's steps on the same weights and draws. The kernel's
own parity tests are in tests/test_torch_segment.py.

Everything is fp32 and compares at rtol = atol = 1e-5, the reference's
bar for this kernel (tests/test_kernels.py), unless a test states and
derives a wider one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import calibrate_threshold as ref_calibrate
from repro.configs import dcn_v2 as ref_dcn_v2, deepfm as ref_deepfm
from repro.models import recsys as RR
from repro_torch.configs import dcn_v2, deepfm
from repro_torch.examples import recsys_routing as example
from repro_torch.kernels import cuda_build
from repro_torch.kernels.segment_reduce import kernel as K
from repro_torch.models import recsys as R

TOL = dict(rtol=1e-5, atol=1e-5)

REF_CONFIGS = {
    "deepfm": RR.RecsysConfig(
        name="deepfm-tiny", model="deepfm", n_dense=0, n_sparse=6,
        embed_dim=10, vocab_sizes=(50, 70, 30, 90, 40, 60),
        deep_mlp=(32, 16), interaction="fm"),
    "dcn_v2": RR.RecsysConfig(
        name="dcn-tiny", model="dcn_v2", n_dense=5, n_sparse=4,
        embed_dim=16, vocab_sizes=(40, 3, 700, 25), deep_mlp=(48, 24),
        n_cross_layers=3, interaction="cross"),
    "dlrm": RR.RecsysConfig(
        name="dlrm-tiny", model="dlrm", n_dense=13, n_sparse=5,
        embed_dim=8, vocab_sizes=(30, 10, 600, 4, 55), bot_mlp=(32, 8),
        top_mlp=(32, 16, 1), interaction="dot"),
    "dien": RR.RecsysConfig(
        name="dien-tiny", model="dien", n_dense=0, n_sparse=3,
        embed_dim=6, vocab_sizes=(100, 80, 12), deep_mlp=(24, 8),
        seq_len=6, gru_dim=12, interaction="augru"),
}


def _shared_fields() -> set:
    """The fields both configs have, but the dtypes (torch vs jnp); the
    reference's own knobs (``scan_unroll``) keep their defaults."""
    return ({f.name for f in dataclasses.fields(R.RecsysConfig)} &
            {f.name for f in dataclasses.fields(RR.RecsysConfig)}) - \
        {"dtype", "param_dtype"}


def port_config(ref_cfg) -> R.RecsysConfig:
    return R.RecsysConfig(**{k: getattr(ref_cfg, k)
                             for k in _shared_fields()})


def ref_config(cfg: R.RecsysConfig) -> RR.RecsysConfig:
    return RR.RecsysConfig(**{k: getattr(cfg, k) for k in _shared_fields()})


REF_SMALL = ref_config(example.SMALL_CFG)
REF_LARGE = ref_config(example.LARGE_CFG)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def ref_params(rcfg, seed: int):
    """The reference's weights, made once per config and seed (jitted:
    its eager initialiser takes seconds per model)."""
    return jax.jit(RR.init_params, static_argnums=1)(jax.random.key(seed),
                                                      rcfg)


def both_models(name: str, seed: int = 0):
    """(ref cfg, ref params, port cfg, port params): the port's weights are
    the reference's, carried across as numpy."""
    rcfg = REF_CONFIGS[name]
    rparams = ref_params(rcfg, seed)
    cfg = port_config(rcfg)
    return rcfg, rparams, cfg, R.params_from_jax(to_np(rparams), cfg, "cpu")


def make_batch(cfg, b: int, seed: int) -> dict:
    """numpy inputs of every field the model kind reads; DIEN's history
    mask is ragged (lengths 1..seq_len, one row of full length)."""
    rng = np.random.default_rng(seed)
    if cfg.model == "dien":
        s = cfg.seq_len
        lengths = rng.integers(1, s + 1, b)
        lengths[0] = s
        return {
            "user_id": rng.integers(0, cfg.vocab_sizes[0], b),
            "target_item": rng.integers(0, cfg.vocab_sizes[1], b),
            "target_cat": rng.integers(0, cfg.vocab_sizes[2], b),
            "hist_items": rng.integers(0, cfg.vocab_sizes[1], (b, s)),
            "hist_cats": rng.integers(0, cfg.vocab_sizes[2], (b, s)),
            "hist_mask": (np.arange(s)[None, :] < lengths[:, None]
                          ).astype(np.float32)}
    batch = {"sparse": rng.integers(0, np.asarray(cfg.vocab_sizes),
                                    (b, cfg.n_sparse)).astype(np.int32)}
    if cfg.n_dense:
        batch["dense"] = rng.normal(0, 1, (b, cfg.n_dense)).astype(np.float32)
    return batch


def as_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(port, ref, **tol):
    np.testing.assert_allclose(torch.as_tensor(port).numpy(), np.asarray(ref),
                               **(tol or TOL))


# -- the rankers ---------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(REF_CONFIGS))
def test_forward_matches_reference(model):
    rcfg, rparams, cfg, params = both_models(model)
    batch = make_batch(cfg, 9, seed=2)
    got = R.forward(params, cfg, batch)
    assert got.shape == (9,) and got.dtype == torch.float32
    close(got, jax.jit(RR.forward, static_argnums=1)(rparams, rcfg,
                                                     as_jax(batch)))


@pytest.mark.parametrize("model", sorted(REF_CONFIGS))
def test_user_embedding_and_retrieval_scores_match_reference(model):
    rcfg, rparams, cfg, params = both_models(model)
    batch = make_batch(cfg, 7, seed=4)
    close(R.user_embedding(params, cfg, batch),
          jax.jit(RR.user_embedding, static_argnums=1)(rparams, rcfg,
                                                       as_jax(batch)))
    cand = np.random.default_rng(5).integers(0, cfg.padded_vocab, 33)
    got = R.retrieval_scores(params, cfg, batch, torch.from_numpy(cand))
    assert got.shape == (7, 33)
    close(got, jax.jit(RR.retrieval_scores, static_argnums=1)(
        rparams, rcfg, as_jax(batch), jnp.asarray(cand, jnp.int32)))


@pytest.mark.parametrize("model", sorted(REF_CONFIGS))
def test_params_from_jax_keeps_the_layout(model):
    rcfg, rparams, cfg, params = both_models(model)
    ref_leaves = jax.tree_util.tree_leaves_with_path(to_np(rparams))
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(params)}
    assert len(got) == len(ref_leaves)
    for path, leaf in ref_leaves:
        t = got[jax.tree_util.keystr(path)]
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), leaf)
    assert set(params) == set(rparams) == set(R.PARAM_KEYS[model])
    assert params["tables"].shape == (cfg.padded_vocab, cfg.embed_dim)
    with pytest.raises(ValueError, match="groups"):
        R.params_from_jax({"tables": to_np(rparams)["tables"]}, cfg, "cpu")


def test_init_params_shapes_match_reference():
    """The port's initialiser makes the reference's layout and shapes."""
    for name, rcfg in REF_CONFIGS.items():
        cfg = port_config(rcfg)
        got = R.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        want = jax.eval_shape(functools.partial(RR.init_params, cfg=rcfg),
                              jax.random.key(0))
        assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda x: 0, got)) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda x: 0, want)), name
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert tuple(a.shape) == b.shape, name


def test_kernel_path_shape_on_the_cpu(monkeypatch):
    """The reduces the kernel carries: one ``embedding_bag_fused`` per
    ``user_embedding`` (dcn_v2, deepfm), one ``segment_sum_sorted`` per
    deepfm ``forward``, none in dcn_v2's; on the CPU no launch is
    counted."""
    calls = {"segment_sum_sorted": 0, "embedding_bag": 0}
    seg, bag = K.segment_sum_sorted, K.embedding_bag

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(K, "segment_sum_sorted",
                        count("segment_sum_sorted", seg))
    monkeypatch.setattr(K, "embedding_bag", count("embedding_bag", bag))
    before = dict(cuda_build.LAUNCHES)
    for model, want in (("deepfm", (1, 1)), ("dcn_v2", (1, 0))):
        _, _, cfg, params = both_models(model)
        batch = make_batch(cfg, 5, seed=9)
        for k in calls:
            calls[k] = 0
        R.user_embedding(params, cfg, batch)
        assert calls == {"segment_sum_sorted": 0, "embedding_bag": 1}
        R.forward(params, cfg, batch)
        assert (calls["embedding_bag"], calls["segment_sum_sorted"]) == want
    assert cuda_build.LAUNCHES == before


def test_full_width_configs_match_reference():
    for port, ref, rows in ((deepfm, ref_deepfm, 39_000_064),
                            (dcn_v2, ref_dcn_v2, 33_762_816)):
        assert port.CONFIG == port_config(ref.CONFIG)
        assert port.CONFIG.padded_vocab == ref.CONFIG.padded_vocab == rows
        np.testing.assert_array_equal(port.CONFIG.row_offsets,
                                      ref.CONFIG.row_offsets)
        assert port.SOURCE == ref.ARCH.source


def test_loss_is_not_ported_yet():
    _, _, cfg, params = both_models("deepfm")
    batch = make_batch(cfg, 3, seed=0)
    batch["labels"] = np.ones(3, np.float32)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        R.loss(params, cfg, batch)


# -- the example, end to end ---------------------------------------------------

def test_recsys_example_matches_reference_steps():
    """The port's example on the reference's weights against the
    reference example's steps (examples/recsys_routing.py): the same
    draws, theta within 1e-6, the same tiers and escalation count, and
    each served request's logit as the reference ranker gives it."""
    small_ref = ref_params(REF_SMALL, 0)        # key(0), as the example's
    large_ref = ref_params(REF_LARGE, 1)
    rng = np.random.default_rng(0)
    user_fields = rng.integers(0, 2000, (64, REF_SMALL.n_sparse))
    cand_ids = rng.integers(0, REF_SMALL.padded_vocab, (100,))
    scores = jax.jit(RR.retrieval_scores, static_argnums=1)(
        small_ref, REF_SMALL, {"sparse": jnp.asarray(user_fields, jnp.int32)},
        jnp.asarray(cand_ids, jnp.int32))
    scores_desc = jnp.sort(scores, axis=1)[:, ::-1]
    theta = ref_calibrate(scores_desc, target_large_ratio=0.3,
                          metric="entropy")
    session = ref_api.build(ref_api.RouteSpec(
        metric="entropy", thresholds=(theta,), top_k=100,
        tier_names=("deepfm-small", "dcnv2-large")))
    res = session.route(np.asarray(scores_desc))

    out = example.main(device="cpu", params=(
        R.params_from_jax(to_np(small_ref), example.SMALL_CFG, "cpu"),
        R.params_from_jax(to_np(large_ref), example.LARGE_CFG, "cpu")),
        verbose=False)
    assert abs(out["theta"] - float(theta)) <= 1e-6
    np.testing.assert_array_equal(out["tiers"], np.asarray(res.tiers))
    assert out["escalated"] == int((np.asarray(res.tiers) > 0).sum())
    close(out["scores_desc"], scores_desc)

    _, _, dense, sparse = example.make_requests(
        np.random.default_rng(0), example.SMALL_CFG, example.LARGE_CFG,
        64, 100)
    r0, r1 = out["rows"][0], out["rows"][1]
    ref_forward = jax.jit(RR.forward, static_argnums=1)
    close(out["logits"][r0], ref_forward(
        small_ref, REF_SMALL, {"sparse": jnp.asarray(user_fields[r0])}))
    close(out["logits"][r1], ref_forward(
        large_ref, REF_LARGE, {"dense": jnp.asarray(dense[r1]),
                               "sparse": jnp.asarray(sparse[r1])}))
