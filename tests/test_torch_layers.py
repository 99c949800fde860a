"""Port parity of the transformer building blocks (`repro_torch.models.
layers`) against `repro.models.layers`, on the CPU.

Inputs are made from a numpy seed and handed to both packages. fp32
compares at 1e-5; bf16 at 2e-2 (the reference's bf16 attention bar,
tests/test_kernels.py): the two frameworks round bf16 products at other
places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import internlm2_20b as ref_internlm, yi_6b as ref_yi
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import internlm2_20b, yi_6b
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def close(port: torch.Tensor, ref, dtype: str):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (3, 7, 64)).astype(np.float32)
    scale = rng.normal(0, 0.3, (64,)).astype(np.float32)
    (jx, tx), (js, ts) = pair(x, dtype), pair(scale, dtype)
    close(L.rms_norm(tx, ts, 1e-5), RL.rms_norm(jx, js, 1e-5), dtype)
    assert L.rms_norm(tx, ts).dtype == tx.dtype
    np.testing.assert_array_equal(L.init_rms_norm(64).float().numpy(),
                                  np.asarray(RL.init_rms_norm(64),
                                             np.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_apply_rope(theta, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 48, 4, 32)).astype(np.float32)
    jx, tx = pair(x, dtype)
    np.testing.assert_allclose(L.rope_frequencies(32, theta).numpy(),
                               np.asarray(RL.rope_frequencies(32, theta)),
                               rtol=1e-6)
    pos1 = np.arange(48, dtype=np.int32)
    close(L.apply_rope(tx, torch.as_tensor(pos1), theta),
          RL.apply_rope(jx, jnp.asarray(pos1), theta), dtype)
    pos2 = rng.integers(0, 2048, (2, 48)).astype(np.int32)  # [B, S]
    close(L.apply_rope(tx, torch.as_tensor(pos2), theta),
          RL.apply_rope(jx, jnp.asarray(pos2), theta), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2)])
def test_gqa_attention_with_masks(h, kv, dtype):
    rng = np.random.default_rng(h * 10 + kv)
    b, s, dh = 2, 24, 16
    q = rng.normal(0, 1, (b, s, h, dh)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kv, dh)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kv, dh)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, k, v))
    np.testing.assert_array_equal(L.causal_mask(s, s, 3).numpy(),
                                  np.asarray(RL.causal_mask(s, s, 3)))
    # causal (prefill) and decode-style (one query, cache masked at 11)
    close(L.gqa_attention(tq, tk, tv, L.causal_mask(s, s)),
          RL.gqa_attention(jq, jk, jv, RL.causal_mask(s, s)), dtype)
    tmask = L.causal_mask(1, s, 10) & (torch.arange(s) < 11)
    jmask = jnp.logical_and(RL.causal_mask(1, s, 10), jnp.arange(s) < 11)
    close(L.gqa_attention(tq[:, :1], tk, tv, tmask),
          RL.gqa_attention(jq[:, :1], jk, jv, jmask), dtype)
    close(L.gqa_attention(tq, tk, tv, None),
          RL.gqa_attention(jq, jk, jv, None), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_glu_mlp(activation, dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 5, 32)).astype(np.float32)
    w = {"w_gate": rng.normal(0, 32 ** -0.5, (32, 64)),
         "w_up": rng.normal(0, 32 ** -0.5, (32, 64)),
         "w_down": rng.normal(0, 64 ** -0.5, (64, 32))}
    jp, tp = {}, {}
    for name, arr in w.items():
        jp[name], tp[name] = pair(arr.astype(np.float32), dtype)
    jx, tx = pair(x, dtype)
    close(L.glu_mlp(tp, tx, activation), RL.glu_mlp(jp, jx, activation),
          dtype)
    with pytest.raises(ValueError):
        L.glu_mlp(tp, tx, "relu")


def test_moe_is_a_later_slice():
    cfg = L.LMConfig(name="m", n_layers=1, d_model=16, n_heads=2,
                     n_kv_heads=1, head_dim=8, d_ff=32, vocab=64,
                     moe=L.MoEConfig(n_experts=4, top_k=2, d_ff=16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.moe_mlp({}, torch.zeros(1, 1, 16), cfg)
    with pytest.raises(NotImplementedError):
        T.init_params(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("port,ref", [(yi_6b, ref_yi),
                                      (internlm2_20b, ref_internlm)],
                         ids=["yi-6b", "internlm2-20b"])
def test_tier_configs_match_the_reference(port, ref):
    ref_fields = dataclasses.asdict(ref.CONFIG)
    for f in dataclasses.fields(port.CONFIG):
        want = ref_fields[f.name]
        got = getattr(port.CONFIG, f.name)
        if f.name == "dtype":
            assert got == torch.bfloat16 and want == jnp.bfloat16
        else:
            assert got == want, f.name
    assert port.CONFIG.n_params == ref.CONFIG.n_params


def test_init_matches_reference_shapes_and_carries_bf16_weights():
    rcfg = RL.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                       n_kv_heads=2, head_dim=8, d_ff=48, vocab=100,
                       tie_embeddings=False)
    cfg = L.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                     n_kv_heads=2, head_dim=8, d_ff=48, vocab=100,
                     tie_embeddings=False)
    ref = jax.tree_util.tree_map(np.asarray,
                                 RT.init_params(jax.random.key(0), rcfg))
    assert ref["embed"].dtype == ml_dtypes.bfloat16
    port = T.init_params(torch.Generator().manual_seed(0), cfg)
    carried = T.params_from_jax(ref, cfg, device="cpu")
    for got in (port, carried):
        assert len(got["layers"]) == 2
        assert got["embed"].shape == ref["embed"].shape
        assert got["lm_head"].shape == ref["lm_head"].shape
        for name in ("wq", "wk", "wv", "wo"):
            assert got["layers"][1]["attn"][name].shape == \
                ref["layers"]["attn"][name].shape[1:]
            assert got["layers"][1]["attn"][name].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        carried["layers"][1]["mlp"]["w_down"].float().numpy(),
        ref["layers"]["mlp"]["w_down"][1].astype(np.float32))
    # init scales follow the reference's fan-in rule
    assert abs(float(port["embed"].float().std()) - 32 ** -0.5) < 0.01
