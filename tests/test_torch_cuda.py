"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: each test skips where there is no CUDA device (as
on a CPU-only host); on the GPU host run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only the port is installed. Tolerances:
skew metrics atol 1e-5 + rtol 1e-5 with cumulative-k exact; the scorer
1e-5 at Dt=110; attention and the segment sums 1e-5 in fp32 (the reference's bar,
tests/test_kernels.py) and one bf16 ulp of the output in bf16. The
attention kernels and their plain versions both do fp32 math, so in
bf16 they differ only where a sum taken in another order rounds to a
neighbouring bf16 value: at most 2^-7 of the value. The reference's
2e-2 bf16 bar is half an output at long lengths (outputs averaged over
~2,000 random keys have rms ~0.04), too loose to catch a dropped tile.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import RouteSpec, build, make_backend
from repro_torch.kernels import cuda_build
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.segment_reduce import kernel as sr
from repro_torch.kernels.segment_reduce import ops as seg_ops
from repro_torch.kernels.segment_reduce import ref as seg_ref
from repro_torch.kernels.skew_metrics import kernel as sk
from repro_torch.kernels.triple_score import kernel as ts
from repro_torch.models import recsys as rec
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import LMConfig
from repro_torch.retrieval import scorer as sc
from repro_torch.serving.engine import LMEngine, make_engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the port's kernels "
                    "have no CPU mode (their plain versions are tested "
                    "against the reference in the other test_torch_* files)")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1, 37, 100, 200])
def test_skew_kernel_matches_plain(cuda, k):
    gen = torch.Generator(device=cuda).manual_seed(k)
    s = torch.sort(torch.rand(512, k, generator=gen, device=cuda) * 1.5
                   - 0.5, dim=1, descending=True).values.contiguous()
    nv = torch.randint(0, k + 1, (512,), generator=gen, device=cuda,
                       dtype=torch.int32)
    for n_valid in (None, nv):
        before = cuda_build.LAUNCHES["skew_metrics"]
        got = sk.skew_metrics(s, n_valid).cpu()
        assert cuda_build.LAUNCHES["skew_metrics"] == before + 1
        want = sk.skew_metrics_plain(s, n_valid).cpu()
        torch.testing.assert_close(got[:, 1], want[:, 1], atol=0, rtol=0)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 129, 512])
def test_triple_score_kernels_match_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    cfg = sc.ScorerConfig()
    params = sc.init_scorer(gen, cfg, device=cuda)
    w = sc.kernel_weights(params)
    feats = torch.randn(8, n, cfg.d_triple, generator=gen).to(cuda)
    q = torch.randn(8, cfg.d_query, generator=gen).to(cuda)
    torch.testing.assert_close(ts.triple_score_batched(feats, q, *w),
                               ts.triple_score_batched_plain(feats, q, *w),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ts.triple_score(feats[0], q[:3], *w),
                               ts.triple_score_plain(feats[0], q[:3], *w),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):          # no silent CPU path
        ts.triple_score_batched(feats, q.cpu(), *w)


def test_session_goes_through_the_kernels(cuda):
    gen = torch.Generator().manual_seed(0)
    cfg = sc.ScorerConfig()
    params = sc.init_scorer(gen, cfg)
    rng = np.random.default_rng(0)
    feats = rng.normal(0, 1, (64, 300, cfg.d_triple)).astype(np.float32)
    qemb = rng.normal(0, 1, (64, cfg.d_query)).astype(np.float32)
    session = build(RouteSpec(thresholds=(-0.05,)))
    cuda_build.reset_launches()
    session.route_retrieved(feats[:1], qemb[:1], params)
    assert not any(cuda_build.LAUNCHES.values())    # B=1: oracle side
    res = session.route_retrieved(feats, qemb, params)
    assert cuda_build.LAUNCHES["skew_metrics"] == 1
    assert cuda_build.LAUNCHES["triple_score_batched"] == 1
    want = make_backend("oracle").route_retrieved(feats, qemb, params,
                                                  session.spec.router_config())
    assert (res.tiers == want.tiers.cpu().numpy()).mean() > 0.98
    np.testing.assert_allclose(res.probs, want.probs.cpu().numpy(),
                               atol=1e-5)


ATTN_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=1e-3, rtol=2 ** -7)}
# (H, KV, Dh): yi-6b, internlm2-20b, MHA, the reference tests' widths
HEADS = [(32, 4, 128), (48, 8, 128), (8, 8, 64), (4, 2, 32), (2, 1, 16)]


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", [1, 16, 100, 512])
@pytest.mark.parametrize("h,kv,dh", HEADS)
def test_flash_kernel_matches_plain(cuda, h, kv, dh, s, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s * h + dh)
    # q, k, v as head slices of one fused [B, S, H + 2 KV, Dh] projection:
    # strided views, as a fused qkv layer would hand them over
    qkv = _randn(gen, (2, s, h + 2 * kv, dh), dtype, cuda)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    before = cuda_build.LAUNCHES["flash_attention"]
    got = fk.flash_attention(q, k, v)
    assert cuda_build.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got, fk.flash_attention_plain(q, k, v),
                               **ATTN_TOL[dtype])
    # the reference-layout wrapper hands over transposed views
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    torch.testing.assert_close(flash_ops.flash_attention(qt, kt, vt),
                               flash_ops.attention_ref(qt, kt, vt),
                               **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,kv_lens", [(200, (1, 17, 127, 128, 129, 200)),
                                       (2048, (1, 1873, 2048))])
@pytest.mark.parametrize("h,kv,dh", HEADS)
def test_decode_kernel_matches_plain(cuda, h, kv, dh, s, kv_lens, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + h + dh)
    # one layer of the engine's flat [B, S, KV*Dh] cache, viewed per head
    ck = _randn(gen, (3, s, kv * dh), dtype, cuda).view(3, s, kv, dh)
    cv = _randn(gen, (3, s, kv * dh), dtype, cuda).view(3, s, kv, dh)
    q = _randn(gen, (3, 1, h, dh), dtype, cuda)[:, 0]
    for kv_len in kv_lens:
        before = cuda_build.LAUNCHES["decode_attention"]
        got = dk.decode_attention(q, ck, cv, kv_len)
        assert cuda_build.LAUNCHES["decode_attention"] == before + 1
        torch.testing.assert_close(
            got, dk.decode_attention_plain(q, ck, cv, kv_len),
            **ATTN_TOL[dtype])
        kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
        torch.testing.assert_close(
            decode_ops.decode_attention(q, kt, vt, kv_len),
            decode_ops.decode_ref(q, kt, vt, kv_len), **ATTN_TOL[dtype])


# (H, KV, Dh) by GQA group: MHA, internlm2-20b's 48/8, yi-6b's 32/4
GROUPS = {1: (8, 8, 64), 6: (48, 8, 128), 8: (32, 4, 128)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_flash_kernel_at_tile_edges(cuda, group, s, dtype):
    """Lengths on either side of the 64-row query tiles and 64-key K/V
    tiles: a partial last tile, a diagonal tile that is also the last,
    one row."""
    h, kv, dh = GROUPS[group]
    gen = torch.Generator(device=cuda).manual_seed(s * group)
    qkv = _randn(gen, (2, s, h + 2 * kv, dh), dtype, cuda)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    before = cuda_build.LAUNCHES["flash_attention"]
    got = fk.flash_attention(q, k, v)
    assert cuda_build.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got, fk.flash_attention_plain(q, k, v),
                               **ATTN_TOL[dtype])


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_flash_kernel_served_length_bf16(cuda, group):
    """bf16 at the served 2048 bucket, one sequence: 32 query tiles, the
    longest walking all 32 key tiles through the cp.async ring."""
    h, kv, dh = GROUPS[group]
    gen = torch.Generator(device=cuda).manual_seed(group)
    q = _randn(gen, (1, 2048, h, dh), torch.bfloat16, cuda)
    k = _randn(gen, (1, 2048, kv, dh), torch.bfloat16, cuda)
    v = _randn(gen, (1, 2048, kv, dh), torch.bfloat16, cuda)
    torch.testing.assert_close(fk.flash_attention(q, k, v),
                               fk.flash_attention_plain(q, k, v),
                               **ATTN_TOL[torch.bfloat16])


def _decode_case(kind: str, kv: int, n_sm: int) -> tuple[int, int, int]:
    """(B, S, kv_len) whose chunk plan is ``kind``: one chunk, two, or
    chunks of uneven size (the last holding fewer tiles)."""
    if kind == "one":
        return 64 // kv, 300, 100
    if kind == "two":
        return 1, 300, 200
    b, s = 64 // kv, 2048
    return b, s, next(n for n in range(dk.TILE + 1, s + 1)
                      if -(-n // dk.TILE) % dk.split_plan(b, kv, n, n_sm)[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["one", "two", "uneven"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_decode_kernel_chunk_plans(cuda, group, kind, dtype):
    """One, two and uneven chunks of the cache, and kv_len 1 and S at
    the same shape; every wrapper call counts one launch, whether it ran
    the split kernel alone or split and combine."""
    h, kv, dh = GROUPS[group]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    b, s, kv_len = _decode_case(kind, kv, n_sm)
    splits, per = dk.split_plan(b, kv, kv_len, n_sm)
    n_tiles = -(-kv_len // dk.TILE)
    assert {"one": splits == 1, "two": splits == 2,
            "uneven": splits > 1 and n_tiles % per != 0}[kind]
    gen = torch.Generator(device=cuda).manual_seed(b * s + group)
    ck = _randn(gen, (b, s, kv * dh), dtype, cuda).view(b, s, kv, dh)
    cv = _randn(gen, (b, s, kv * dh), dtype, cuda).view(b, s, kv, dh)
    q = _randn(gen, (b, h, dh), dtype, cuda)
    for n in (kv_len, 1, s):
        before = cuda_build.LAUNCHES["decode_attention"]
        got = dk.decode_attention(q, ck, cv, n)
        assert cuda_build.LAUNCHES["decode_attention"] == before + 1
        torch.testing.assert_close(
            got, dk.decode_attention_plain(q, ck, cv, n), **ATTN_TOL[dtype])


def test_attention_kernels_raise_rather_than_fall_back(cuda):
    """A CUDA tensor the kernels cannot take raises, and nothing is
    launched: no plain-version fallback on the card."""
    x = torch.randn(2, 16, 4, 32, device=cuda)
    cache = torch.randn(2, 64, 2, 32, device=cuda)
    q1 = torch.randn(2, 4, 32, device=cuda)
    xt = torch.randn(2, 16, 32, 4, device=cuda).transpose(2, 3)
    ct = torch.randn(2, 64, 32, 2, device=cuda).transpose(2, 3)
    before = dict(cuda_build.LAUNCHES)
    bad_flash = [
        (x.half(), x.half(), x.half()),                  # dtype
        (x, x.double(), x),                              # mixed dtypes
        (x, x.cpu(), x),                                 # mixed devices
        (xt, xt, xt),                                    # Dh not contiguous
        (x[..., 1:17], x[..., 1:17], x[..., 1:17]),      # rows misaligned
        (x[..., :24], x[..., :24], x[..., :24]),         # Dh 24
        (x, x[:, :, :3], x[:, :, :3]),                   # H % KV != 0
    ]
    for q, k, v in bad_flash:
        with pytest.raises((ValueError, TypeError)):
            fk.flash_attention(q, k, v)
    bad_decode = [
        (q1.half(), cache.half(), cache.half(), 5),
        (q1, cache.cpu(), cache, 5),
        (q1[:, :, 1:17], cache[..., 1:17], cache[..., 1:17], 5),
        (q1, ct, ct, 5),
        (q1, cache, cache, 0),
        (q1, cache, cache, 65),
        (torch.randn(2, 34, 32, device=cuda), cache[:, :, :1],
         cache[:, :, :1], 5),                            # H / KV = 34 > 16
    ]
    for q, k, v, n in bad_decode:
        with pytest.raises((ValueError, TypeError)):
            dk.decode_attention(q, k, v, n)
    assert cuda_build.LAUNCHES == before


def test_engine_runs_the_attention_kernels(cuda):
    """A tiny fp32 model on the card: prefill launches the flash kernel
    once per layer and each decode step the decode kernel once per layer;
    logits match the plain attention path (``attn_impl="full"``) and the
    greedy tokens match the CPU run of the same weights."""
    cfg = LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
                   dtype=torch.float32)
    engine = make_engine(cfg, seed=0)
    tokens = torch.randint(1, 256, (2, 100), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(0))
    cuda_build.reset_launches()
    logits, cache = tfm.prefill(engine.params, tokens, cfg)
    assert cuda_build.LAUNCHES["flash_attention"] == cfg.n_layers
    full = dataclasses.replace(cfg, attn_impl="full")
    want, want_cache = tfm.prefill(engine.params, tokens, full)
    torch.testing.assert_close(logits, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(cache["k"], want_cache["k"], atol=1e-5,
                               rtol=1e-5)
    cache = {kv: torch.cat([c, torch.zeros_like(c)], 2)
             for kv, c in cache.items()}
    want_cache = {kv: c.clone() for kv, c in cache.items()}
    logits, _ = tfm.decode_step(engine.params, cache, tokens[:, :1], 100,
                                cfg)
    assert cuda_build.LAUNCHES["decode_attention"] == cfg.n_layers
    want, _ = tfm.decode_step(engine.params, want_cache, tokens[:, :1], 100,
                              full)
    torch.testing.assert_close(logits, want, atol=1e-5, rtol=1e-5)
    prompts = np.random.default_rng(0).integers(1, 256, (3, 37)).astype(
        np.int32)
    cpu = LMEngine(cfg, _to_cpu(engine.params))
    np.testing.assert_array_equal(engine.generate(prompts, 8).tokens,
                                  cpu.generate(prompts, 8).tokens)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


SEG_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
           torch.bfloat16: dict(atol=1e-3, rtol=2 ** -7)}


def _sorted_segments(gen, s: int, r: int, dev, pads: bool):
    """``r`` rows per segment; with ``pads`` ~30% of rows and all of
    segment 0 are -1."""
    seg = torch.arange(s, device=dev, dtype=torch.int32).repeat_interleave(r)
    if pads:
        drop = torch.rand(s * r, generator=gen, device=dev) < 0.3
        seg = torch.where(drop, -1, seg)
        seg[:r] = -1
    return seg.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,r,d", [(8, 4, 16), (16, 8, 32), (32, 2, 64),
                                   (8, 4, 1), (64, 39, 10), (64, 39, 21),
                                   (64, 1, 128), (512, 39, 10),
                                   (100, 16, 128), (3, 5, 256)])
def test_segment_sum_kernel_matches_plain(cuda, s, r, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s * r + d)
    for pads, offset in ((False, 0), (True, 0), (True, 1)):
        # offset 1: rows start 4 (fp32) or 2 (bf16) bytes past an aligned
        # address, so the kernel must take its narrow loads
        flat = _randn(gen, (s * r * d + offset,), dtype, cuda)
        rows = flat[offset:].view(s * r, d)
        seg = _sorted_segments(gen, s, r, cuda, pads)
        before = cuda_build.LAUNCHES["segment_sum_sorted"]
        got = sr.segment_sum_sorted(rows, seg, s, r)
        assert cuda_build.LAUNCHES["segment_sum_sorted"] == before + 1
        assert got.dtype == dtype
        torch.testing.assert_close(
            got, sr.segment_sum_sorted_plain(rows, seg, s, r),
            **SEG_TOL[dtype])
        torch.testing.assert_close(
            got.float(), seg_ref.segment_sum_sorted_ref(rows.float(), seg, s),
            **SEG_TOL[dtype])
        if pads:
            assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("b,nnz,d", [(8, 5, 1), (512, 39, 10), (64, 26, 16),
                                     (256, 16, 128), (4, 3, 21)])
def test_embedding_bag_kernel_matches_plain(cuda, b, nnz, d, combiner,
                                            dtype):
    gen = torch.Generator(device=cuda).manual_seed(b + nnz + d)
    for offset in (0, 1):
        flat = _randn(gen, (1000 * d + offset,), dtype, cuda)
        table = flat[offset:].view(1000, d)
        ids = torch.randint(-1, 1000, (b, nnz), generator=gen, device=cuda,
                            dtype=torch.int32)
        ids[1] = -1                                  # an all-pad bag
        ids[2, 0] = 1000                             # past the table
        before = cuda_build.LAUNCHES["embedding_bag"]
        got = seg_ops.embedding_bag_fused(table, ids, b, combiner)
        assert cuda_build.LAUNCHES["embedding_bag"] == before + 1
        want = sr.embedding_bag_plain(table, ids, combiner == "mean")
        assert cuda_build.LAUNCHES["embedding_bag"] == before + 1
        torch.testing.assert_close(got, want, equal_nan=True,
                                   **SEG_TOL[dtype])
        assert not got[1].any()
        assert got[2].isnan().all()
        assert not got[torch.arange(b, device=cuda) != 2].isnan().any()


RECSYS_TINY = {
    "deepfm": rec.RecsysConfig(
        name="deepfm-tiny", model="deepfm", n_dense=0, n_sparse=39,
        embed_dim=10, vocab_sizes=(300,) * 39, deep_mlp=(64, 32),
        interaction="fm"),
    "dcn_v2": rec.RecsysConfig(
        name="dcn-tiny", model="dcn_v2", n_dense=13, n_sparse=26,
        embed_dim=16, vocab_sizes=(200,) * 26, deep_mlp=(64, 32),
        n_cross_layers=3, interaction="cross"),
}


def test_recsys_path_launches_the_segment_kernel(cuda):
    """One gather-reduce launch per ``user_embedding`` (deepfm, dcn_v2),
    one segment-sum launch per deepfm ``forward``, none in dcn_v2's; the
    results match the plain segment sums on the card and the CPU run of
    the same weights."""
    rng = np.random.default_rng(0)
    for model, fwd_launches in (("deepfm", 1), ("dcn_v2", 0)):
        cfg = RECSYS_TINY[model]
        params = rec.init_params(0, cfg, cuda)
        batch = {"sparse": torch.as_tensor(
            rng.integers(0, 300 if model == "deepfm" else 200,
                         (96, cfg.n_sparse)), device=cuda)}
        if cfg.n_dense:
            batch["dense"] = torch.randn(96, cfg.n_dense, device=cuda)
        cuda_build.reset_launches()
        u = rec.user_embedding(params, cfg, batch)
        assert cuda_build.LAUNCHES["embedding_bag"] == 1
        assert cuda_build.LAUNCHES["segment_sum_sorted"] == 0
        logits = rec.forward(params, cfg, batch)
        assert cuda_build.LAUNCHES["segment_sum_sorted"] == fwd_launches
        assert cuda_build.LAUNCHES["embedding_bag"] == 1
        cand = torch.arange(0, cfg.padded_vocab, 7, device=cuda)
        scores = rec.retrieval_scores(params, cfg, batch, cand)
        assert cuda_build.LAUNCHES["embedding_bag"] == 2
        before = dict(cuda_build.LAUNCHES)
        with pytest.MonkeyPatch.context() as mp:     # the plain segment sums
            mp.setattr(sr, "segment_sum_sorted",
                       lambda rows, seg, s, r, seg_tile=8:
                       sr.segment_sum_sorted_plain(rows, seg, s, r))
            mp.setattr(sr, "embedding_bag", sr.embedding_bag_plain)
            torch.testing.assert_close(
                u, rec.user_embedding(params, cfg, batch),
                atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(
                logits, rec.forward(params, cfg, batch),
                atol=1e-5, rtol=1e-5)
        assert cuda_build.LAUNCHES == before
        cpu_params = _to_cpu(params)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        torch.testing.assert_close(
            scores.cpu(), rec.retrieval_scores(cpu_params, cfg, cpu_batch,
                                               cand.cpu()),
            atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(
            logits.cpu(), rec.forward(cpu_params, cfg, cpu_batch),
            atol=1e-4, rtol=1e-5)


def test_segment_kernel_raises_rather_than_falls_back(cuda):
    """N != S*r, a dtype the kernel does not take, and a CPU/CUDA mix
    raise on the card, and nothing is launched."""
    rows = torch.randn(12, 8, device=cuda)
    seg = torch.arange(4, device=cuda, dtype=torch.int32).repeat_interleave(3)
    table = torch.randn(50, 8, device=cuda)
    ids = torch.randint(-1, 50, (4, 3), device=cuda, dtype=torch.int32)
    before = dict(cuda_build.LAUNCHES)
    bad_segment_sum = [
        (rows, seg, 4, 4),                               # N != S*r
        (rows, seg, 5, 3),
        (rows.double(), seg, 4, 3),                      # dtype
        (rows.half(), seg, 4, 3),
        (rows, seg.long(), 4, 3),                        # seg_ids dtype
        (rows, seg.cpu(), 4, 3),                         # mixed devices
        (rows.cpu(), seg, 4, 3),
        (rows.t().contiguous().t(), seg, 4, 3),          # not contiguous
    ]
    for args in bad_segment_sum:
        with pytest.raises((ValueError, TypeError)):
            sr.segment_sum_sorted(*args)
    bad_bag = [
        (table.double(), ids), (table.half(), ids),      # dtype
        (table, ids.long()),                             # ids dtype
        (table, ids.cpu()), (table.cpu(), ids),          # mixed devices
        (table, ids[0]),                                 # ids not [S, r]
    ]
    for t, i in bad_bag:
        with pytest.raises((ValueError, TypeError)):
            sr.embedding_bag(t, i)
    assert cuda_build.LAUNCHES == before
