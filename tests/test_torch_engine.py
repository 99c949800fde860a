"""Port parity of the tier engines: `repro_torch.models.transformer`
(prefill, decode_step) and `repro_torch.serving.engine` (LMEngine,
EngineBank) against the reference, on the CPU at fp32 with the
reference's weights carried across by `params_from_jax`.

Configs are the reference tests' tiny ones (tests/test_transformer.py,
tests/test_serving_pipeline.py). Logits and caches compare at 1e-5;
greedy tokens must be equal — including a prompt shorter than its
length bucket, whose first token the reference reads at a pad position.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro_torch.api as api
from repro.models import transformer as RT
from repro.models.layers import LMConfig as RefLMConfig
from repro.serving import engine as RE
from repro_torch.kernels import cuda_build
from repro_torch.models import transformer as T
from repro_torch.models.layers import LMConfig
from repro_torch.serving import engine as E

TOL = 1e-5

REF_CONFIGS = {
    "dense": RefLMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
                         dtype=jnp.float32, loss_chunk=8),
    "gemma": RefLMConfig(name="tiny-gemma", n_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                         vocab=256, dtype=jnp.float32, loss_chunk=8,
                         activation="geglu", tie_embeddings=True,
                         scale_embed=True),
    "small": RefLMConfig(name="s", n_layers=1, d_model=32, n_heads=2,
                         n_kv_heads=1, head_dim=16, d_ff=64, vocab=128,
                         dtype=jnp.float32),
    "large": RefLMConfig(name="l", n_layers=2, d_model=32, n_heads=2,
                         n_kv_heads=1, head_dim=16, d_ff=64, vocab=128,
                         dtype=jnp.float32),
}


def port_config(ref_cfg: RefLMConfig) -> LMConfig:
    shared = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(LMConfig) if f.name != "dtype"}
    return LMConfig(**shared, dtype=torch.float32)


def both_models(name: str, seed: int = 0):
    """(ref cfg, ref params, port cfg, port params): the port's weights
    are the reference's, carried across as numpy."""
    rcfg = REF_CONFIGS[name]
    rparams = RT.init_params(jax.random.key(seed), rcfg)
    cfg = port_config(rcfg)
    params = T.params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                               cfg, device="cpu")
    return rcfg, rparams, cfg, params


@pytest.mark.parametrize("name", ["dense", "gemma"])
def test_prefill_then_decode_match_reference(name):
    rcfg, rparams, cfg, params = both_models(name)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    r_logits, r_cache = RT.prefill(rparams, jnp.asarray(tokens), rcfg)
    logits, cache = T.prefill(params, torch.as_tensor(tokens), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               atol=TOL, rtol=TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache[kv].numpy(),
                                   np.asarray(r_cache[kv]), atol=TOL,
                                   rtol=TOL)
    # decode three tokens into a longer cache holding the prefill
    total = 32
    r_full = {kv: jnp.zeros((cfg.n_layers, 2, total, cfg.kv_dim),
                            jnp.float32).at[:, :, :16].set(r_cache[kv])
              for kv in ("k", "v")}
    full = T.init_cache(cfg, 2, total, dtype=torch.float32, device="cpu")
    for kv in ("k", "v"):
        full[kv][:, :, :16] = cache[kv]
    for i in range(3):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        r_logits, r_full = RT.decode_step(rparams, r_full, jnp.asarray(nxt),
                                          jnp.int32(16 + i), rcfg)
        logits, full = T.decode_step(params, full, torch.as_tensor(nxt),
                                     16 + i, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   atol=TOL, rtol=TOL)
        for kv in ("k", "v"):
            np.testing.assert_allclose(full[kv].numpy(),
                                       np.asarray(r_full[kv]), atol=TOL,
                                       rtol=TOL)


def test_full_attention_path_matches_kernel_path():
    """``attn_impl="full"`` (the plain masked softmax) computes what the
    kernels' path computes."""
    _, _, cfg, params = both_models("dense")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))
    full = dataclasses.replace(cfg, attn_impl="full")
    a, ca = T.prefill(params, tokens, cfg)
    b, cb = T.prefill(params, tokens, full)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
    nxt = tokens[:, :1]
    a, _ = T.decode_step(params, ca, nxt, 20, cfg)
    b, _ = T.decode_step(params, cb, nxt, 20, full)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="chunked"):
        T.attention(tokens, tokens, tokens, cfg, impl="chunked")


@pytest.mark.parametrize("name", ["dense", "gemma"])
def test_generate_greedy_tokens_equal_reference(name):
    rcfg, rparams, cfg, params = both_models(name, seed=3)
    ref, port = RE.LMEngine(rcfg, rparams), E.LMEngine(cfg, params)
    rng = np.random.default_rng(4)
    before = dict(cuda_build.LAUNCHES)
    # s=9 is below its bucket of 16 (first token read at a pad slot);
    # s=16 fills it; s=20 rounds up to 32
    for s in (9, 16, 20):
        prompts = rng.integers(1, cfg.vocab, (3, s)).astype(np.int32)
        want = ref.generate(prompts, max_new=6)
        got = port.generate(prompts, max_new=6)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert (got.prompt_tokens, got.generated_tokens) == \
            (want.prompt_tokens, want.generated_tokens)
    assert cuda_build.LAUNCHES == before      # CPU: plain versions only
    # EOS: stop once every row emits eos_id
    prompt = rng.integers(1, cfg.vocab, (1, 7)).astype(np.int32)
    full = ref.generate(prompt, max_new=8).tokens[0]
    eos = int(full[2])
    want = ref.generate(prompt, max_new=8, eos_id=eos)
    got = port.generate(prompt, max_new=8, eos_id=eos)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens.shape[1] == list(full).index(eos) + 1


def test_prefill_reads_the_last_padded_position():
    """The reference's first token comes from hidden[:, -1] of the padded
    bucket; a prompt shorter than its bucket gives another first token
    than the same prompt run unpadded."""
    _, _, cfg, params = both_models("dense", seed=5)
    prompt = np.random.default_rng(6).integers(1, cfg.vocab,
                                               (1, 9)).astype(np.int32)
    padded = np.zeros((1, 16), np.int32)
    padded[:, :9] = prompt
    logits_pad, _ = T.prefill(params, torch.as_tensor(padded), cfg)
    first = E.LMEngine(cfg, params).generate(prompt, max_new=1).tokens
    assert int(first[0, 0]) == int(torch.argmax(logits_pad[0]))


def test_session_with_engine_bank_matches_reference():
    """build(spec, runners=EngineBank(...).runners()): the same tier per
    request and the same tokens per micro-batch as the reference's
    build with its own EngineBank."""
    engines, ref_engines = {}, {}
    for tier, name in enumerate(("small", "large")):
        rcfg, rparams, cfg, params = both_models(name, seed=tier)
        ref_engines[tier] = RE.LMEngine(rcfg, rparams)
        engines[tier] = E.LMEngine(cfg, params)
    payload = ref_api.RouteSpec(metric="entropy", thresholds=(6.0,),
                                tier_names=("small", "large"),
                                micro_batch=4).to_json()
    port = api.build(api.RouteSpec.from_json(payload),
                     runners=E.EngineBank(engines, max_new=4).runners(),
                     device="cpu")
    ref = ref_api.build(ref_api.RouteSpec.from_json(payload),
                        runners=RE.EngineBank(ref_engines,
                                              max_new=4).runners())
    rng = np.random.default_rng(5)
    for b in (8, 5):
        # power-law rows with varied decay: entropies on both sides of 6
        alpha = rng.uniform(0.05, 1.5, (b, 1))
        scores = (1.0 / np.arange(1, 101) ** alpha).astype(np.float32)
        prompts = [rng.integers(1, 128, rng.integers(3, 9)).astype(np.int32)
                   for _ in range(b)]
        got = port.submit(scores, payloads=prompts)
        want = ref.submit(scores, payloads=prompts)
        np.testing.assert_array_equal(np.asarray(got.tiers),
                                      np.asarray(want.tiers))
    assert port.flush() == ref.flush()
    assert len(port.executed) == len(ref.executed) >= 3
    assert {b.tier for b in port.executed} == {0, 1}
    for g, w in zip(port.executed, ref.executed):
        assert (g.tier, g.size) == (w.tier, w.size)
        assert g.result.tokens.shape == (g.size, 4)
        np.testing.assert_array_equal(g.result.tokens, w.result.tokens)


def test_make_engine_draws_weights_on_the_requested_device():
    cfg = port_config(REF_CONFIGS["small"])
    a = E.make_engine(cfg, seed=7, device="cpu")
    b = E.make_engine(cfg, seed=7, device="cpu")
    assert a.device.type == "cpu"
    torch.testing.assert_close(a.params["layers"][0]["attn"]["wq"],
                               b.params["layers"][0]["attn"]["wq"])
    out = E.EngineBank({0: a}, max_new=3).run_tier(
        0, [np.array([5, 6, 7], np.int32), np.array([9], np.int32)])
    assert out.tokens.shape == (2, 3)
    with pytest.raises(ValueError):
        E.EngineBank({})
