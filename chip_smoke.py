#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of SkewRoute on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # the whole run, one CUDA device
    python3 chip_smoke.py --kernels-only   # build + kernel-vs-plain checks

Needs a CUDA device and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` at the start). Imports nothing of JAX
and nothing of the JAX package. Phases, each fatal on failure:

1. device   — the card (``nvidia-smi``), torch/CUDA versions, kernel build.
2. kernels  — every CUDA kernel against its plain PyTorch version on the
              card, at the main path's shapes and the edge cases (flash
              at lengths straddling its 64-row tiles; decode with one
              chunk and with chunks of uneven size).
3. server   — the main path, through the user's entry points: a session
              built from a ``RouteSpec`` JSON answers request batches at
              the KGQA serving width (Dt=110, H=128) and the paper-scale
              scorer width (Dt=1156, H=1024); results are held against
              the ``oracle`` backend on the card and the host-staged
              reference on the CPU; a snapshot restores into a fresh
              session. Kernel launches are counted over this phase only.
4. times    — CUDA-event times of every kernel beside its plain version,
              a library call where one exists, and its bound; end-to-end
              ``route_retrieved`` times for ``fused`` and ``oracle``.
5. recsys   — the recsys rankers behind SkewRoute at full width: deepfm
              (tier 0) and dcn-v2 (tier 1) with random fp32 weights made
              on the card. The port's recsys example routes B=512 requests
              against C=1,000,000 candidates (user_embedding through the
              segment kernel -> scores -> top-100 -> calibrate_threshold ->
              build -> route) and serves each with its tier's ranker;
              launches counted exactly over it; held against the same path
              with the plain segment sums; the kernel at the served shapes
              and the reference bench's production shape beside its plain
              version, torch.segment_reduce / F.embedding_bag and its
              bound; routing-batch and ranker times (serve_p99, serve_bulk).
6. tiers    — the LLM tiers behind the router at full width: yi-6b (tier
              0) and internlm2-20b (tier 1) with random bf16 weights made
              on the card, served through ``build(spec, runners=
              EngineBank(...).runners())`` with the KGQA session's
              calibrated spec: 32 requests of ~1,500-2,000-token prompts.
              Kernel launches are counted over this phase only. Then one
              prefill and one decode step per tier held against the plain
              attention path, prefill/decode times with a device
              breakdown, and the attention kernels' times at the served
              shapes beside their plain versions, PyTorch's
              ``scaled_dot_product_attention`` and their bound.

The second-to-last line is ``nvidia-smi``'s name and power limit, the
line before it lists the kernels as JSON, and the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): device memory
# bandwidth and fp32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12    # tensor cores, dense

# Kernel vs plain version, same inputs, same card:
SKEW_TOL = dict(atol=1e-5, rtol=1e-5)        # reference's skew-metric bar
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)       # reference's scorer bar (Dt~110)
# Dt=1156, H=1024: each score is a 1024-term sum of relu'd 1156-term fp32
# sums, taken in another order than cuBLAS takes them; the rounding that
# leaves is ~sqrt(terms) ulps of the partial sums (~1e-6 at these
# magnitudes), so 5e-5 absolute is headroom, not slack.
SCORE_TOL_WIDE = dict(atol=5e-5, rtol=1e-5)
# Whole path vs whole path (fused kernels vs oracle on the card, vs the
# staged path on the CPU): the candidate logits come from different fp32
# summation orders (~1e-6 apart), and min-max normalisation divides by the
# row's score range, which can amplify that tenfold in the area metric.
# For the same reason cumulative-k may move by one in a row whose CDF lies
# within rounding of P; such rows are counted and printed (the exact
# check of that column is kernel vs plain version, on the same inputs).
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
TINY = 5.6406751573846435e-34   # the reference's near-zero-total example
# Attention kernels vs their plain versions. fp32: the reference's bar
# (tests/test_kernels.py:25). bf16: both sides do fp32 math and differ
# only where a sum taken in another order rounds to a neighbouring bf16
# value, one ulp, at most 2^-7 of the value; atol 1e-3 covers outputs
# near 0. The reference's 2e-2 bar would be half an output at S=2048
# (outputs averaged over ~2,000 random keys have rms ~0.04).
ATTN_TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
            "bf16": dict(atol=1e-3, rtol=2 ** -7)}
# The kernels of phase server's path (the routing server).
SERVER_KERNELS = ("skew_metrics", "triple_score_batched", "triple_score")
# The attention shapes of the two tiers: (H, KV, Dh).
TIER_HEADS = {"yi-6b": (32, 4, 128), "internlm2-20b": (48, 8, 128)}
# Phase tiers: requests, prompt lengths around the paper's KG-RAG prompt
# of 1,873 tokens (src/repro/core/cost.py:27), tokens generated each.
TIER_REQUESTS = 32
PROMPT_LENGTHS = (1500, 2000)
MAX_NEW = 16
# Whole-model check, kernels vs the plain attention path (attn_impl=
# "full"), bf16 weights: the two paths differ only inside attention, by
# about one bf16 rounding (unit roundoff u = 2^-8) of its output. Every
# later bf16 product rounds again, so the difference grows like a random
# walk over the layers, sqrt(L) u in relative size; the logits are read
# off a bf16 GEMM, adding their own rounding. Bound: max abs difference
# <= 16 sqrt(L) u rms(logits), mean abs difference <= 4 sqrt(L) u
# rms(logits). A wrong stride, head mapping or mask moves logits by
# O(rms).
BF16_U = 2.0 ** -8

# segment_sum_sorted / embedding_bag vs their plain versions. fp32: the
# reference's bar (tests/test_kernels.py:87). bf16: both sum in fp32 and
# round once to bf16, so they differ by at most one bf16 ulp (2^-7 of the
# value) where the fp32 sums straddle a rounding boundary.
SEG_TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
           "bf16": dict(atol=1e-3, rtol=2 ** -7)}
FP32_U = 2.0 ** -24            # fp32 unit roundoff
# Phase recsys: the reference example's settings (examples/
# recsys_routing.py: entropy, 30% large-ranker budget, top-K) at the serve
# shapes of configs/base.py:65-69 (serve_p99 B=512, serve_bulk B=262,144,
# retrieval_cand C=1,000,000), K=100 as the session's [B, K] contract.
# The kernel's production shape is the reference bench's (benchmarks/
# kernel_bench.py:108): 65,536 bags of 16 rows, D=128, here gathered from a
# 1,000,000-row table.
RECSYS = dict(b=512, bulk=262_144, c=1_000_000, k=100, budget=0.3,
              production=(65_536, 16, 128, 1_000_000))
# The escalated share against the budget: the threshold is the
# interpolated 0.7-quantile of the batch's own difficulties, so the share
# is 154/512 up to rows tied with it or within E2E_TOL of it (the route
# uses the fused kernel's metrics, the calibration the oracle's): 1% is
# five rows of slack.
CAL_TOL = 0.01

# The paper-scale scorer width (src/repro/kernels/triple_score/kernel.py:
# 17-18, benchmarks/kernel_bench.py:75-76) at B=256, N=512. The repo names
# no query width at this scale; Dq only sizes the bias product outside the
# kernel, so ScorerConfig's d_query of 32 is taken.
PAPER = dict(b=256, n=512, dt=1156, dq=32, h=1024)


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    import torch
    got, want = torch.as_tensor(got).double().cpu(), \
        torch.as_tensor(want).double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bad.any():
        i = tuple(int(x) for x in bad.nonzero()[0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} values outside atol {atol} + rtol "
            f"{rtol}; first at {i}: {float(got[i])} vs {float(want[i])}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_skew(what: str, got, want, scores, n_valid, p_cdf=0.95) -> float:
    """Metric columns within SKEW_TOL, cumulative-k exact; a row whose
    count differs is printed with its CDF around P."""
    import torch
    from repro_torch.kernels.skew_metrics.kernel import p_threshold
    diff = (got[:, 1] != want[:, 1]).nonzero().flatten().tolist()
    for r in diff[:5]:
        nv = scores.shape[1] if n_valid is None else int(n_valid[r])
        nv = min(max(nv, 1), scores.shape[1])
        s = scores[r, :nv].double()
        sh = s - min(float(s.min()), 0.0)
        cdf = torch.cumsum(sh / sh.sum(), 0)
        j = int(min(want[r, 1], got[r, 1])) - 1
        log(f"  {what}: row {r} cumulative-k {float(got[r, 1])} vs "
            f"{float(want[r, 1])}; CDF[{j}:{j + 2}] = "
            f"{cdf[j:j + 2].tolist()} vs P-eps {p_threshold(p_cdf)}")
    if diff:
        raise AssertionError(f"{what}: cumulative-k differs in "
                             f"{len(diff)} rows")
    return check_close(what, got, want, **SKEW_TOL)


def sync_time(fn, reps: int) -> float:
    """Median host-clock ms of ``fn()`` ending in a device synchronize."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def event_time(fn, iters: int, reps: int = 5, warmup: int = 2) -> float:
    """Median over ``reps`` of CUDA-event ms per call, over ``iters``
    back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / iters)
    return statistics.median(out)


def kernel_device_ms(fn, iters: int, kernel: str):
    """Device time (ms) per call of ``fn`` in the kernels whose names
    contain ``kernel``, from the profiler's CUPTI trace over ``iters``
    calls, and how many such kernels ran per call. Per call, not per
    kernel: a wrapper that launches two kernels (decode's split and
    combine) is timed for both. Each kernel name's mean time is counted
    as often per call as it ran (its count over ``iters``, rounded), so
    an event the trace misses at the edge of the window moves nothing.
    (None, 0) when the trace holds no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = per_call = 0
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", 0) or \
            getattr(e, "cuda_time_total", 0)
        if kernel in e.key and e.count and total:
            n = max(1, round(e.count / iters))
            ms += total / e.count / 1e3 * n
            per_call += n
    return (ms, per_call) if per_call else (None, 0)


def device_breakdown(fn, reps: int) -> dict:
    """Wall ms per call of ``fn`` (ending in a synchronize) under a
    CUDA-only profiler, the device's busy ms per call (the sum of its
    kernel, copy and set durations) and so its idle share, and the five
    largest device activities."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    acts = sorted(((getattr(e, "self_device_time_total", 0) / 1e3 / reps,
                    e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(ms for ms, _ in acts)
    return dict(wall_ms=wall, busy_ms=busy,
                idle_share=1.0 - busy / wall if busy else None,
                top=[[name[:60], ms] for ms, name in acts[:5]])


# -- inputs -------------------------------------------------------------------

def desc_scores(gen, b: int, k: int, lo: float, hi: float, dev):
    import torch
    s = torch.rand(b, k, generator=gen, device=dev) * (hi - lo) + lo
    return torch.sort(s, dim=1, descending=True).values.contiguous()


def ragged(gen, b: int, k: int, dev):
    import torch
    nv = torch.randint(0, k + 1, (b,), generator=gen, device=dev,
                       dtype=torch.int32)
    nv[:2] = torch.tensor([0, 1], dtype=torch.int32)
    return nv


def paper_params(gen, dt: int, dq: int, h: int, dev) -> dict:
    """He-initialised scorer weights at an arbitrary width."""
    import torch

    def normal(*shape, fan_in):
        return torch.randn(*shape, generator=gen, device=dev) \
            * (2.0 / fan_in) ** 0.5

    return {"w1_t": normal(dt, h, fan_in=dt), "w1_q": normal(dq, h, fan_in=dq),
            "b1": torch.zeros(h, device=dev), "w2": normal(h, 1, fan_in=h),
            "b2": torch.zeros(1, device=dev)}


# -- phases -------------------------------------------------------------------

def kernel_label(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name: the length-prefixed
    identifier ending in ``kernel``, its element type and int args."""
    import re
    for start in range(len(mangled)):
        m = re.match(r"\d+", mangled[start:])
        if not m:
            continue
        n, i = int(m.group()), start + m.end()
        name = mangled[i:i + n]
        if len(name) == n and name.endswith("kernel"):
            rest = mangled[i + n:]
            if not rest.startswith("I"):
                return name
            tmpl = rest[1:rest.find("EEv") + 1] if "EEv" in rest else ""
            args = ["bf16"] if "bfloat16" in tmpl else \
                ["fp32"] if tmpl.startswith("f") else []
            args += re.findall(r"L[ib](\d+)E", tmpl)
            return f"{name}<{', '.join(args)}>"
    return mangled[:60]


def phase_device(dev) -> dict:
    import torch
    from repro_torch.kernels import cuda_build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"phase device: {torch.cuda.get_device_name(dev)} | nvidia-smi: "
        f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    log("phase device: TF32 off for matmul and cuDNN (every fp32 product "
        "here is full fp32)")
    secs = cuda_build.build_all()
    log(f"phase device: kernels built and loaded in {secs:.1f} s")
    for name, text in cuda_build.BUILD_LOG.items():
        fn = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = kernel_label(line.rsplit(" ", 1)[-1])
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {fn}: "
                    f"{line.split(':', 1)[-1].strip()}")
    return {"smi": smi, "build_s": secs}


def phase_kernels(dev, errs: dict) -> None:
    import torch
    from repro_torch.kernels.skew_metrics import kernel as sk
    from repro_torch.kernels.triple_score import kernel as ts
    gen = torch.Generator(device=dev).manual_seed(SEED)

    cases = []
    for k in (1, 37, 100, 200):
        cases.append((f"B=256 K={k} dense", desc_scores(gen, 256, k, 0.01, 1.0,
                                                        dev), None))
        cases.append((f"B=256 K={k} ragged logits",
                      desc_scores(gen, 256, k, -0.5, 1.0, dev),
                      ragged(gen, 256, k, dev)))
    cases.append(("B=4096 K=100 ragged", desc_scores(gen, 4096, 100, 0.01,
                                                     1.0, dev),
                  ragged(gen, 4096, 100, dev)))
    for value in (TINY, 0.0, 0.7, -1.3):
        for k in (2, 100):
            cases.append((f"constant {value:g} K={k}",
                          torch.full((3, k), value, device=dev), None))
    worst = 0.0
    for what, s, nv in cases:
        for p_cdf in (0.95, 0.8):
            e = check_skew(f"skew_metrics {what} P={p_cdf}",
                           sk.skew_metrics(s, nv, p_cdf),
                           sk.skew_metrics_plain(s, nv, p_cdf), s, nv, p_cdf)
            worst = max(worst, e)
    tiny = sk.skew_metrics(torch.full((1, 2), TINY, device=dev)).cpu()
    if tiny[0].tolist() != [0.0, 2.0, 0.0, 1.0]:
        raise AssertionError(f"near-zero total row: {tiny[0].tolist()}, "
                             f"reference gives [0, 2, 0, 1]")
    errs["skew_metrics"] = worst
    log(f"phase kernels: skew_metrics == plain at K in (1, 37, 100, 200), "
        f"B in (256, 4096), ragged n_valid incl. 0 and 1, constant rows "
        f"incl. {TINY:g}: max abs err {worst:.3g} (atol 1e-5 + rtol 1e-5, "
        f"cumulative-k exact)")

    worst_b = worst_s = 0.0
    for (b, dt, dq, h, tol) in ((64, 110, 32, 128, SCORE_TOL),
                                (PAPER["b"], PAPER["dt"], PAPER["dq"],
                                 PAPER["h"], SCORE_TOL_WIDE)):
        w = paper_params(gen, dt, dq, h, dev)
        w["b1"] = torch.randn(h, generator=gen, device=dev) * 0.1
        w["b2"] = torch.randn(1, generator=gen, device=dev)
        args = [w[k] for k in ("w1_t", "w1_q", "b1", "w2", "b2")]
        for n in ((1, 129, 512) if dt == 110 else (PAPER["n"],)):
            feats = torch.randn(b, n, dt, generator=gen, device=dev)
            q = torch.randn(b, dq, generator=gen, device=dev)
            e = check_close(f"triple_score_batched B={b} N={n} Dt={dt}",
                            ts.triple_score_batched(feats, q, *args),
                            ts.triple_score_batched_plain(feats, q, *args),
                            **tol)
            worst_b = max(worst_b, e)
            log(f"phase kernels: triple_score_batched B={b} N={n} Dt={dt} "
                f"Dq={dq} H={h}: max abs err {e:.3g} ({tol})")
            qs = q[:3]
            e = check_close(f"triple_score N={n} Q=3 Dt={dt}",
                            ts.triple_score(feats[0], qs, *args),
                            ts.triple_score_plain(feats[0], qs, *args), **tol)
            worst_s = max(worst_s, e)
            log(f"phase kernels: triple_score N={n} Q=3 Dt={dt} H={h}: "
                f"max abs err {e:.3g} ({tol})")
        del feats
    errs["triple_score_batched"] = worst_b
    errs["triple_score"] = worst_s
    torch.cuda.synchronize()
    check_attention_kernels(dev, errs)
    check_segment_kernels(dev, errs)


# Flash lengths: the tiers' (16, 100, 512, 2048) and those straddling the
# 64-row / 64-key tiles (1, 63, 65, 127, 129).
FLASH_LENGTHS = (1, 16, 63, 65, 100, 127, 129, 512, 2048)


def check_attention_kernels(dev, errs: dict) -> None:
    """Flash and decode kernels vs their plain versions at the tiers'
    attention shapes: q/k/v as head slices of one fused projection
    (strided views), lengths that are not multiples of a tile, the decode
    cache as the engine's flat [B, S, KV*Dh] layer viewed per head; decode
    at B=2 and at B * KV = 64 (the served B=8 for internlm2-20b), where
    one kv_len takes a single chunk and another chunks of uneven size."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = {"flash_attention": {}, "decode_attention": {}}
    plans = {}
    for name, (h, kv, dh) in TIER_HEADS.items():
        for dtype, tname in ((torch.bfloat16, "bf16"),
                             (torch.float32, "fp32")):
            for s in FLASH_LENGTHS:
                b = 1 if s == 2048 else 2   # the plain version is [B,H,S,S]
                qkv = torch.randn(b, s, h + 2 * kv, dh, generator=gen,
                                  device=dev).to(dtype)
                q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], \
                    qkv[:, :, h + kv:]
                e = check_close(f"flash_attention {name} S={s} {tname}",
                                fk.flash_attention(q, k, v),
                                fk.flash_attention_plain(q, k, v),
                                **ATTN_TOL[tname])
                worst["flash_attention"][tname] = max(
                    e, worst["flash_attention"].get(tname, 0.0))
            s = 2048
            uneven = None
            for b in (2, 64 // kv):
                if b > 2:   # the first kv_len whose chunks differ in size
                    uneven = next(
                        n for n in range(dk.TILE + 1, s + 1)
                        if -(-n // dk.TILE) % dk.split_plan(b, kv, n,
                                                            n_sm)[1])
                ck = torch.randn(b, s, kv * dh, generator=gen,
                                 device=dev).to(dtype).view(b, s, kv, dh)
                cv = torch.randn(b, s, kv * dh, generator=gen,
                                 device=dev).to(dtype).view(b, s, kv, dh)
                q = torch.randn(b, h, dh, generator=gen, device=dev).to(dtype)
                lens = (1, 17, 1873, s) if b == 2 else (dk.TILE, uneven)
                for kv_len in lens:
                    plans[f"{name} B={b} kv_len={kv_len}"] = \
                        dk.split_plan(b, kv, kv_len, n_sm)
                    e = check_close(
                        f"decode_attention {name} B={b} kv_len={kv_len} "
                        f"{tname}",
                        dk.decode_attention(q, ck, cv, kv_len),
                        dk.decode_attention_plain(q, ck, cv, kv_len),
                        **ATTN_TOL[tname])
                    worst["decode_attention"][tname] = max(
                        e, worst["decode_attention"].get(tname, 0.0))
            del qkv, q, k, v, ck, cv
    for kernel, w in worst.items():
        errs[kernel] = max(w.values())
        log(f"phase kernels: {kernel} == plain at (H, KV, Dh) in "
            f"{list(TIER_HEADS.values())}, "
            + (f"S in {FLASH_LENGTHS}" if kernel == "flash_attention"
               else "S=2048, B=2 kv_len in (1, 17, 1873, 2048), B*KV=64 "
                    "kv_len one tile and uneven chunks")
            + f": max abs err bf16 {w['bf16']:.3g} ({ATTN_TOL['bf16']}), "
              f"fp32 {w['fp32']:.3g} ({ATTN_TOL['fp32']})")
    log(f"phase kernels: decode (chunks, tiles per chunk) on {n_sm} SMs: "
        f"{json.dumps(plans)}")
    torch.cuda.synchronize()


class Tally:
    """Launch counts per main-path step, from the wrappers' counters."""

    def __init__(self):
        from repro_torch.kernels import cuda_build
        self.counts = cuda_build.LAUNCHES
        self.per_path: dict[str, dict[str, int]] = {}

    def step(self, name: str, fn):
        import torch
        before = dict(self.counts)
        out = fn()
        torch.cuda.synchronize()
        self.per_path[name] = {k: self.counts[k] - before[k]
                               for k in self.counts}
        return out


def compare_route(what: str, got: dict, want: dict, thresholds) -> int:
    """Tiers equal (outside a band of E2E_TOL around each threshold, whose
    rows are counted), n_valid exact, probs within 1e-5, the other metric
    columns and difficulty within E2E_TOL, cumulative-k within one.
    Returns the rows inside the band."""
    import numpy as np
    from repro_torch.kernels.device import to_numpy
    g = {k: to_numpy(v) for k, v in got.items()}
    w = {k: to_numpy(v) for k, v in want.items()}
    if not np.array_equal(g["n_valid"], w["n_valid"]):
        raise AssertionError(f"{what}: n_valid differs")
    check_close(f"{what} probs", g["probs"], w["probs"], atol=1e-5, rtol=0)
    cols = [0, 2, 3]
    check_close(f"{what} metrics", g["metrics"][:, cols],
                w["metrics"][:, cols], **E2E_TOL)
    check_close(f"{what} difficulty", g["difficulty"], w["difficulty"],
                **E2E_TOL)
    moved = np.flatnonzero(g["metrics"][:, 1] != w["metrics"][:, 1])
    if len(moved):
        log(f"  {what}: cumulative-k differs in rows {moved.tolist()}: "
            f"{g['metrics'][moved, 1].tolist()} vs "
            f"{w['metrics'][moved, 1].tolist()}")
    check_close(f"{what} cumulative-k", g["metrics"][:, 1],
                w["metrics"][:, 1], atol=1.0, rtol=0)
    ts = np.asarray(thresholds, np.float64)
    d = w["difficulty"].astype(np.float64)
    band = E2E_TOL["atol"] + E2E_TOL["rtol"] * np.abs(ts)
    near = (np.abs(d[:, None] - ts[None, :]) <= band[None, :]).any(1)
    wrong = (g["tiers"] != w["tiers"]) & ~near
    if wrong.any():
        raise AssertionError(f"{what}: tiers differ in rows "
                             f"{np.flatnonzero(wrong)[:10].tolist()}")
    return int(near.sum())


def as_route(res) -> dict:
    """A session's RetrievedDispatchResult or a RetrievedRouteResult ->
    the comparable fields."""
    if hasattr(res, "result"):
        return dict(tiers=res.tiers, n_valid=res.n_valid, probs=res.probs,
                    metrics=res.result.metrics,
                    difficulty=res.result.difficulty)
    return dict(tiers=res.tiers, n_valid=res.n_valid, probs=res.probs,
                metrics=res.metrics, difficulty=res.difficulty)


def phase_server(dev, errs: dict) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.api import (CalibrationSpec, RouteSpec,
                                 SkewRouteSession, build, make_backend)
    from repro_torch.core import RouterConfig, calibrate_threshold
    from repro_torch.core.router import (route_retrieved,
                                         route_retrieved_staged)
    from repro_torch.kernels.triple_score import kernel as ts
    from repro_torch.retrieval import scorer as sc
    from repro_torch.retrieval import synthetic

    t0 = time.perf_counter()
    data = synthetic.make_dataset("cwq", n_queries=420, n_entities=4000,
                                  seed=SEED)
    kg, ent, rel = data.kg, data.entity_emb, data.relation_emb
    if len(data.queries) < 420:
        raise AssertionError(f"synthetic CWQ made {len(data.queries)} "
                             f"queries, 420 needed")
    cfg = sc.ScorerConfig()                      # Dt=110, Dq=32, H=128, K=100
    params = sc.init_scorer(torch.Generator().manual_seed(SEED), cfg)
    serve_q = data.queries[100:164]
    feats, qemb, _, n_cand = sc.batch_triple_features(
        kg, ent, rel, serve_q, max_cands=512, seed=SEED)
    one = sc.batch_triple_features(kg, ent, rel, data.queries[164:165],
                                   max_cands=512, seed=SEED)
    log(f"phase server: synthetic CWQ KG of {kg.n_triples} triples; serving "
        f"batch feats {feats.shape}, n_cand {n_cand.min()}..{n_cand.max()} "
        f"({time.perf_counter() - t0:.1f} s host data pipeline)")

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    pw = dict(PAPER)
    p_params = paper_params(gen, pw["dt"], pw["dq"], pw["h"], dev)
    p_feats = torch.randn(pw["b"], pw["n"], pw["dt"], generator=gen,
                          device=dev)
    p_q = torch.randn(pw["b"], pw["dq"], generator=gen, device=dev)
    p_cal_feats = torch.randn(100, pw["n"], pw["dt"], generator=gen,
                              device=dev)
    p_cal_q = torch.randn(100, pw["dq"], generator=gen, device=dev)

    tally = Tally()
    for k in tally.counts:
        tally.counts[k] = 0
    # ---- the main path: launches counted from here ----------------------
    budget = 0.4

    def calibrate_kgqa():
        rows, nvs = [], []
        for q in data.queries[:100]:
            _, probs = sc.retrieve(params, kg, ent, rel, q, cfg, seed=SEED)
            rows.append(np.pad(probs[:100], (0, max(0, 100 - len(probs)))))
            nvs.append(min(len(probs), 100))
        nvs = np.asarray(nvs)
        mask = np.arange(100)[None, :] < nvs[:, None]
        return calibrate_threshold(
            torch.as_tensor(np.stack(rows), device=dev), budget, "gini",
            mask=torch.as_tensor(mask, device=dev))

    theta = tally.step("calibrate: retrieve x100", calibrate_kgqa)
    payload = RouteSpec(
        metric="gini", thresholds=(theta,), tier_names=("qwen7b", "qwen72b"),
        backend="auto", calibration=CalibrationSpec(
            policy="streaming", target_shares=(1 - budget, budget),
            window=1024, min_samples=64)).to_json()
    session = build(RouteSpec.from_json(payload))
    log(f"phase server: gini threshold {theta:.6f} for a {budget:.0%} "
        f"large-tier budget; spec {payload}")

    cfg1 = session.dispatcher.router
    r1 = tally.step("kgqa auto B=1", lambda: session.route_retrieved(
        one[0], one[1], params, n_cand=one[3]))
    cfg64 = session.dispatcher.router
    r64 = tally.step("kgqa auto B=64", lambda: session.route_retrieved(
        feats, qemb, params, n_cand=n_cand))

    spec = RouteSpec.from_json(payload)
    pallas = build(RouteSpec.from_json(
        dataclasses.replace(spec, backend="pallas").to_json()))
    cfgp = pallas.dispatcher.router
    rp = tally.step("kgqa pallas route B=64", lambda: pallas.route(
        r64.probs, n_valid=r64.n_valid))
    rb = tally.step("retrieve_batch B=8", lambda: sc.retrieve_batch(
        params, kg, ent, rel, data.queries[200:208], cfg, seed=SEED))

    def calibrate_paper():
        cal = route_retrieved(p_cal_feats, p_cal_q, p_params,
                              RouterConfig(metric="gini"),
                              use_kernels=False)
        return calibrate_threshold(cal.probs, budget, "gini",
                                   mask=torch.arange(cal.probs.shape[1],
                                                     device=dev)[None]
                                   < cal.n_valid[:, None])

    p_theta = tally.step("paper calibrate (oracle)", calibrate_paper)
    paper = build(RouteSpec.from_json(dataclasses.replace(
        spec, backend="fused", thresholds=(p_theta,)).to_json()))
    cfgw = paper.dispatcher.router
    rw = tally.step("paper fused B=256", lambda: paper.route_retrieved(
        p_feats, p_q, p_params))
    launches = {k: tally.counts[k] for k in SERVER_KERNELS}
    # ---- end of the main path -------------------------------------------
    log(f"phase server: launches per path {json.dumps(tally.per_path)}")
    log(f"phase server: main path launches {json.dumps(launches)}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    for path, need in (("kgqa auto B=64", ("skew_metrics",
                                           "triple_score_batched")),
                       ("paper fused B=256", ("skew_metrics",
                                              "triple_score_batched")),
                       ("kgqa pallas route B=64", ("skew_metrics",)),
                       ("retrieve_batch B=8", ("triple_score_batched",)),
                       ("calibrate: retrieve x100", ("triple_score",))):
        if any(tally.per_path[path][k] < 1 for k in need):
            raise AssertionError(f"{path} did not launch {need}")
    if any(tally.per_path["kgqa auto B=1"].values()):
        raise AssertionError("auto at B=1 launched a kernel; it must take "
                             "the oracle side of the crossover")

    # ---- hold the answers against the oracle (card) and staged (CPU) ----
    oracle = make_backend("oracle")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    bands = {}
    want = oracle.route_retrieved(one[0], one[1], params, cfg1,
                                  n_cand=one[3])
    bands["kgqa B=1 vs oracle"] = compare_route(
        "kgqa auto B=1 vs oracle", as_route(r1), as_route(want),
        cfg1.thresholds)
    want = oracle.route_retrieved(feats, qemb, params, cfg64, n_cand=n_cand)
    bands["kgqa B=64 vs oracle"] = compare_route(
        "kgqa auto B=64 vs oracle", as_route(r64), as_route(want),
        cfg64.thresholds)
    staged = route_retrieved_staged(feats, qemb, cpu_params, cfg64,
                                    n_cand=n_cand)
    bands["kgqa B=64 vs staged"] = compare_route(
        "kgqa auto B=64 vs staged (CPU)", as_route(r64), as_route(staged),
        cfg64.thresholds)
    want_p = oracle.route_batch(r64.probs, cfgp, n_valid=r64.n_valid)
    check_close("pallas route metrics vs oracle", rp.metrics,
                want_p.metrics, **SKEW_TOL)
    if not np.array_equal(rp.tiers, want_p.tiers.cpu().numpy()):
        raise AssertionError("pallas route B=64: tiers differ from oracle")
    want = oracle.route_retrieved(p_feats, p_q, p_params, cfgw)
    bands["paper B=256 vs oracle"] = compare_route(
        "paper fused B=256 vs oracle", as_route(rw), as_route(want),
        cfgw.thresholds)
    staged_w = route_retrieved_staged(p_feats, p_q, p_params, cfgw)
    bands["paper B=256 vs staged"] = compare_route(
        "paper fused B=256 vs staged (CPU)", as_route(rw),
        as_route(staged_w), cfgw.thresholds)
    log(f"phase server: answers == oracle on the card and == staged on the "
        f"CPU (tiers exact; probs atol 1e-5; metrics {E2E_TOL}); rows "
        f"within the tolerance band of a threshold: {json.dumps(bands)}")
    cpu_rb = sc.retrieve_batch(cpu_params, kg, ent, rel,
                               data.queries[200:208], cfg, seed=SEED)
    if not np.array_equal(rb[2], cpu_rb[2]):
        raise AssertionError("retrieve_batch: n_valid differs from the CPU")
    check_close("retrieve_batch probs vs CPU", rb[1], cpu_rb[1], atol=1e-5,
                rtol=0)
    same = (rb[0] == cpu_rb[0]).mean()
    log(f"phase server: retrieve_batch B=8 on the card == CPU (probs atol "
        f"1e-5; {same:.1%} of edge ids identical, the rest ties)")
    e = check_close(
        "triple_score_batched on the KGQA batch",
        ts.triple_score_batched(torch.as_tensor(feats, device=dev),
                                torch.as_tensor(qemb, device=dev),
                                *sc.kernel_weights(params)),
        ts.triple_score_batched_plain(torch.as_tensor(feats, device=dev),
                                      torch.as_tensor(qemb, device=dev),
                                      *sc.kernel_weights(params)),
        **SCORE_TOL)
    errs["triple_score_batched"] = max(errs["triple_score_batched"], e)

    tiers = {"kgqa auto B=1": np.bincount(r1.tiers, minlength=2).tolist(),
             "kgqa auto B=64": np.bincount(r64.tiers, minlength=2).tolist(),
             "kgqa pallas B=64": np.bincount(rp.tiers, minlength=2).tolist(),
             "paper fused B=256": np.bincount(rw.tiers, minlength=2).tolist()}
    log(f"phase server: tier counts {json.dumps(tiers)}; auto's "
        f"crossover_batch {session.backend.crossover_batch}; thresholds "
        f"now {session.thresholds} (kgqa), {paper.thresholds} (paper)")
    snap = json.loads(json.dumps(session.snapshot()))
    restored = SkewRouteSession.from_snapshot(snap)
    if restored.thresholds != session.thresholds or \
            restored.snapshot() != snap:
        raise AssertionError("snapshot did not restore into a fresh session")
    log(f"phase server: snapshot envelope v{snap['envelope_version']} "
        f"({len(json.dumps(snap))} bytes) restored into a fresh session: "
        f"thresholds {restored.thresholds}")
    # the [B, K] rows the skew kernel saw on the main path
    skew_rows = {len(r.probs): (torch.as_tensor(r.probs, device=dev),
                                torch.as_tensor(r.n_valid, device=dev))
                 for r in (rw, r64)}
    return dict(launches=launches, per_path=tally.per_path,
                skew_rows=skew_rows, payload=payload,
                kgqa=dict(feats=feats, qemb=qemb, n_cand=n_cand,
                          params=params, cfg=cfg64, data=data, scfg=cfg),
                paper=dict(feats=p_feats, q=p_q, params=p_params, cfg=cfgw,
                           **pw))


def skew_bound_ms(b: int, k: int, valid: int) -> tuple[float, str]:
    """Bytes: each valid score read once, n_valid read, [B, 4] written.
    Operations: ~20 per valid score (normalise, log2, products, sums)."""
    nbytes = valid * 4 + b * 4 + b * 16
    ops = 20 * valid
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def score_bound_ms(q: int, n: int, dt: int, h: int, shared: bool
                   ) -> tuple[float, str]:
    """Operations: the first layer's 2*Dt*H and the epilogue's ~4*H per
    candidate and query. Bytes: features (once, shared or per query),
    the [Q, H] bias, W1_t, w2, b2 in; [Q, N] scores out."""
    ops = q * n * h * (2 * dt + 4)
    feats = n * dt * 4 * (1 if shared else q)
    nbytes = feats + q * h * 4 + dt * h * 4 + h * 4 + 4 + q * n * 4
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def kernel_ms(raw, iters: int, kernel: str, per_call: int = 1) -> dict:
    """The kernels' own device time per call from the CUPTI trace
    (``ms``), and the CUDA-event time per call of ``iters`` back-to-back
    raw calls (``event_ms``: the issue rate, for microsecond kernels the
    host's ctypes call rather than the card). Raises unless the trace
    shows ``per_call`` matching kernels per call."""
    ev = event_time(raw, iters)
    dev_ms, n = kernel_device_ms(raw, max(iters, 10), kernel)
    if dev_ms is not None and n != per_call:
        raise AssertionError(f"{kernel}: {n} kernels per call in the trace, "
                             f"{per_call} expected")
    return dict(ms=ev if dev_ms is None else dev_ms, event_ms=ev,
                ms_from="cuda events" if dev_ms is None else "cupti trace",
                kernels_per_call=n)


def phase_times(dev, server: dict) -> dict:
    import torch
    from repro_torch.core.router import route_retrieved
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.skew_metrics import kernel as sk
    from repro_torch.kernels.triple_score import kernel as ts
    from repro_torch.retrieval import scorer as sc
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = {}

    # skew_metrics on the rows the main path gave it (K=100; B=256 paper
    # width, B=64 KGQA width) and at the reference bench's B=4096
    rows_in = dict(server["skew_rows"])
    rows_in[4096] = (desc_scores(gen, 4096, 100, 0.01, 1.0, dev),
                     torch.randint(50, 101, (4096,), generator=gen,
                                   device=dev, dtype=torch.int32))
    for b in (256, 64, 4096):
        s, nv = rows_in[b]
        k = s.shape[1]
        out = torch.empty(b, 4, device=dev)

        def raw():
            cuda_build.launch("skew_metrics", s.data_ptr(), nv.data_ptr(),
                              out.data_ptr(), b, k, sk.p_threshold(0.95),
                              stream)
        bound, by = skew_bound_ms(b, k, int(nv.clamp(1, k).sum()))
        rows[f"skew_metrics B={b} K={k}"] = dict(
            name="skew_metrics", shape=[b, k],
            **kernel_ms(raw, 200, "skew_metrics_kernel"),
            call_ms=event_time(lambda: sk.skew_metrics(s, nv), 50),
            plain_ms=event_time(lambda: sk.skew_metrics_plain(s, nv), 20),
            bound_ms=bound, bound_by=by, library_ms=None)

    def score_row(name, feats, q, w, shared):
        fn = ts.triple_score if shared else ts.triple_score_batched
        plain = ts.triple_score_plain if shared else \
            ts.triple_score_batched_plain
        nq = q.shape[0]
        n, dt = feats.shape[-2], feats.shape[-1]
        h = w["w1_t"].shape[1]
        args = sc.kernel_weights(w)
        qb = q @ w["w1_q"] + w["b1"]
        out = torch.empty(nq, n, device=dev)

        def raw():
            cuda_build.launch("triple_score", feats.data_ptr(),
                              0 if shared else n * dt, qb.data_ptr(),
                              w["w1_t"].data_ptr(), w["w2"].data_ptr(),
                              w["b2"].data_ptr(), out.data_ptr(), nq, n, dt,
                              h, stream)

        def library():
            # cuBLAS GEMMs with the bias folded into the first one
            t = feats if not shared else feats.expand(nq, n, dt)
            hid = torch.baddbmm(qb[:, None, :], t,
                                w["w1_t"].expand(nq, dt, h))
            return (torch.relu(hid) @ w["w2"])[..., 0] + w["b2"][0]

        big = nq * n * dt * h > 1e9
        iters = 3 if big else 50
        bound, by = score_bound_ms(nq, n, dt, h, shared)
        rows[name] = dict(
            name="triple_score" if shared else "triple_score_batched",
            shape=[nq, n, dt, q.shape[1], h],
            **kernel_ms(raw, iters, "triple_score_kernel"),
            call_ms=event_time(lambda: fn(feats, q, *args), iters),
            plain_ms=event_time(lambda: plain(feats, q, *args), iters),
            library_ms=event_time(library, iters), bound_ms=bound,
            bound_by=by)

    pw, kq = server["paper"], server["kgqa"]
    score_row("triple_score_batched paper B=256", pw["feats"], pw["q"],
              pw["params"], shared=False)
    kfeats = torch.as_tensor(kq["feats"], device=dev)
    kqemb = torch.as_tensor(kq["qemb"], device=dev)
    score_row("triple_score_batched kgqa B=64", kfeats, kqemb, kq["params"],
              shared=False)
    n0 = int(kq["n_cand"][0])
    score_row("triple_score kgqa retrieve Q=1", kfeats[0, :n0].contiguous(),
              kqemb[:1], kq["params"], shared=True)
    for name, row in rows.items():
        log(f"phase times: {name}: {json.dumps(row)}")

    # end-to-end route_retrieved, fused vs oracle, interleaved per B
    e2e = {}
    for width, d in (("kgqa", None), ("paper", pw)):
        if d is None:
            data, scfg = kq["data"], kq["scfg"]
            f, q, _, nc = sc.batch_triple_features(
                data.kg, data.entity_emb, data.relation_emb,
                data.queries[164:420], max_cands=512, seed=SEED)
            f, q = torch.as_tensor(f, device=dev), torch.as_tensor(q,
                                                                   device=dev)
            nc = torch.as_tensor(nc, device=dev)
            params, cfg = kq["params"], kq["cfg"]
        else:
            f, q, nc, params, cfg = d["feats"], d["q"], None, d["params"], \
                d["cfg"]
        for b in (1, 8, 32, 64, 256):
            args = (f[:b], q[:b], params, cfg)
            kw = dict(n_cand=None if nc is None else nc[:b])
            fused = lambda: route_retrieved(*args, use_kernels=True, **kw)
            orc = lambda: route_retrieved(*args, use_kernels=False, **kw)
            reps = 5 if width == "paper" else 20
            fns = {"fused": fused, "oracle": orc}
            fused(), orc()
            t = {"fused": [], "oracle": []}
            for order in (("fused", "oracle"), ("oracle", "fused")):
                for path in order:
                    t[path].append(sync_time(fns[path], reps))
            e2e[f"{width} B={b}"] = dict(
                B=b, fused_ms=statistics.median(t["fused"]),
                oracle_ms=statistics.median(t["oracle"]))
            log(f"phase times: route_retrieved {width} width "
                f"{json.dumps(e2e[f'{width} B={b}'])}")
            if (width, b) in (("kgqa", 64), ("paper", 256)):
                for path, fn in fns.items():
                    bd = device_breakdown(fn, reps)
                    e2e[f"{width} B={b}"][f"{path}_device"] = bd
                    log(f"phase times: {width} B={b} {path}: device busy "
                        f"{bd['busy_ms']:.4f} of {bd['wall_ms']:.4f} ms per "
                        f"call (idle share {bd['idle_share']}); top "
                        f"{json.dumps(bd['top'])}")
    for width in ("kgqa", "paper"):
        wins = [v["B"] for k, v in e2e.items()
                if k.startswith(width) and v["fused_ms"] <= v["oracle_ms"]]
        log(f"phase times: {width} width: fused <= oracle at B={wins}")
    return dict(kernels=rows, e2e=e2e)


def flash_bound_ms(b: int, s: int, h: int, kv: int, dh: int,
                   elem: int) -> tuple[float, str]:
    """Operations: causal, so query i meets i + 1 keys; 2 Dh FLOPs each
    for q.k and for p.v. Bytes: q, k, v read once, o written once."""
    flops = b * h * 2 * dh * s * (s + 1)
    nbytes = b * s * (2 * h + 2 * kv) * dh * elem
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOP_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def decode_bound_ms(b: int, kv_len: int, h: int, kv: int, dh: int,
                    elem: int) -> tuple[float, str]:
    """Operations: 4 Dh FLOPs per query head and valid cache position.
    Bytes: q, the kv_len valid positions of k and v, o."""
    flops = b * h * 4 * dh * kv_len
    nbytes = (b * 2 * h * dh + b * 2 * kv_len * kv * dh) * elem
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOP_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def compare_logits(what: str, got, want, n_layers: int) -> dict:
    """Kernel-path vs plain-path logits under the bf16 bound stated at
    BF16_U (max <= 16 sqrt(L) u rms, mean <= 4 sqrt(L) u rms); returns
    the numbers, raises outside the bound."""
    import torch
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits")
    rms = float(want.pow(2).mean().sqrt())
    scale = (n_layers ** 0.5) * BF16_U * rms
    diff = (got - want).abs()
    out = dict(max_abs=float(diff.max()), mean_abs=float(diff.mean()),
               bound_max=16 * scale, bound_mean=4 * scale, rms=rms,
               argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                  .double().mean()))
    if out["max_abs"] > out["bound_max"] or \
            out["mean_abs"] > out["bound_mean"]:
        raise AssertionError(f"{what}: kernels vs plain attention outside "
                             f"the bf16 bound: {out}")
    return out


def phase_tiers(dev, errs: dict, server: dict) -> dict:
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.api import RouteSpec, build
    from repro_torch.configs import internlm2_20b, yi_6b
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer as tfm
    from repro_torch.retrieval import scorer as sc
    from repro_torch.serving.engine import EngineBank, make_engine

    # ---- the tiers, initialised on the card from seeded generators -------
    t0 = time.perf_counter()
    configs = {0: yi_6b.CONFIG, 1: internlm2_20b.CONFIG}
    engines = {t: make_engine(c, seed=SEED + t) for t, c in configs.items()}
    torch.cuda.synchronize()
    gib = {c.name: c.n_params * 2 / 2 ** 30 for c in configs.values()}
    log(f"phase tiers: {', '.join(f'{c.name} {c.n_layers} layers' for c in configs.values())} "
        f"(weights {json.dumps(gib)} GiB bf16) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s; device memory allocated "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB")

    kq = server["kgqa"]
    data, params, scfg = kq["data"], kq["params"], kq["scfg"]
    rng = np.random.default_rng(SEED)
    vocab = min(c.vocab for c in configs.values())
    lengths = rng.integers(PROMPT_LENGTHS[0], PROMPT_LENGTHS[1] + 1,
                           TIER_REQUESTS)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]
    bank = EngineBank(engines, max_new=MAX_NEW)
    session = build(RouteSpec.from_json(server["payload"]),
                    runners=bank.runners())

    # ---- the main path: launches counted from here ----------------------
    cuda_build.reset_launches()
    t1 = time.perf_counter()
    for start in range(0, TIER_REQUESTS, 16):   # serve.py's request batches
        rows, nvs = [], []
        for q in data.queries[100 + start:100 + start + 16]:
            _, probs = sc.retrieve(params, data.kg, data.entity_emb,
                                   data.relation_emb, q, scfg, seed=SEED)
            rows.append(np.pad(probs[:100], (0, max(0, 100 - len(probs)))))
            nvs.append(min(len(probs), 100))
        session.submit(np.stack(rows), prompts[start:start + 16],
                       n_valid=np.asarray(nvs, np.int32))
    session.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(cuda_build.LAUNCHES)
    # ---- end of the main path -------------------------------------------
    batches = [dict(tier=b.tier, size=b.size,
                    tokens=list(b.result.tokens.shape))
               for b in session.executed]
    log(f"phase tiers: served {TIER_REQUESTS} requests (prompts "
        f"{int(lengths.min())}..{int(lengths.max())} tokens) in {wall:.2f} s "
        f"over micro-batches {json.dumps(batches)}; launches "
        f"{json.dumps(launches)}")
    if sum(b["size"] for b in batches) != TIER_REQUESTS:
        raise AssertionError(f"executed {batches}, {TIER_REQUESTS} requests "
                             f"submitted")
    if {b["tier"] for b in batches} != set(configs):
        raise AssertionError(f"both tiers must get traffic: {batches}")
    for b in session.executed:
        toks = b.result.tokens
        if toks.shape != (b.size, MAX_NEW) or toks.min() < 0 or \
                toks.max() >= configs[b.tier].vocab:
            raise AssertionError(f"tier {b.tier} micro-batch returned "
                                 f"tokens {toks.shape} in "
                                 f"[{toks.min()}, {toks.max()}]")
    # the decode lengths the served micro-batches hit: each decodes at
    # kv_len = s + i + 1 for its longest prompt s and step i < MAX_NEW
    served_kv = {}
    for b in session.executed:
        s = b.result.prompt_tokens // b.size
        served_kv.setdefault(configs[b.tier].name, set()).update(
            (s + 1, s + MAX_NEW))
    want = {"flash_attention": sum(configs[b["tier"]].n_layers
                                   for b in batches),
            "decode_attention": sum(configs[b["tier"]].n_layers * MAX_NEW
                                    for b in batches)}
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{k}: {launches[k]} launches on the main "
                                 f"path, {n} expected (one per layer per "
                                 f"prefill / decode step)")

    # ---- kernels vs the plain attention path, whole model ---------------
    parity, times = {}, {}
    s_prompt = 1873                       # the paper's mean KG-RAG prompt
    for tier, eng in engines.items():
        cfg = eng.cfg
        full = dataclasses.replace(cfg, attn_impl="full")
        toks = np.zeros((2, 2048), np.int32)
        toks[:, :s_prompt] = rng.integers(1, vocab, (2, s_prompt))
        toks = torch.as_tensor(toks, device=dev)
        lk, ck = tfm.prefill(eng.params, toks, cfg)
        lf, cf = tfm.prefill(eng.params, toks, full)
        res = {"prefill": compare_logits(f"{cfg.name} prefill", lk, lf,
                                         cfg.n_layers)}
        nxt = torch.argmax(lf, -1)[:, None]
        lk, _ = tfm.decode_step(eng.params, ck, nxt, s_prompt, cfg)
        lf, _ = tfm.decode_step(eng.params, cf, nxt, s_prompt, full)
        res["decode"] = compare_logits(f"{cfg.name} decode", lk, lf,
                                       cfg.n_layers)
        parity[cfg.name] = res
        log(f"phase tiers: {cfg.name} kernels vs plain attention, B=2 "
            f"S={s_prompt} (bucket 2048): {json.dumps(res)}")
        del ck, cf

        # ---- prefill per micro-batch and decode per token --------------
        b = 8
        mb = torch.as_tensor(np.stack(
            [np.pad(p[:2000], (0, 2048 - len(p[:2000]))) for p in prompts[:b]]
        ), device=dev)
        holder = {}

        def run_prefill():
            holder["logits"], holder["cache"] = tfm.prefill(eng.params, mb,
                                                            cfg)
        prefill_ms = sync_time(run_prefill, 2)
        step = iter(range(s_prompt, 2048))
        first = torch.argmax(holder["logits"], -1)[:, None]

        def run_decode():
            tfm.decode_step(eng.params, holder["cache"], first, next(step),
                            cfg)
        decode_ms = sync_time(run_decode, 8)
        bd_prefill = device_breakdown(run_prefill, 1)
        bd_decode = device_breakdown(run_decode, 4)
        times[cfg.name] = dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                               batch=b, seq=2048,
                               prefill_device=bd_prefill,
                               decode_device=bd_decode)
        log(f"phase tiers: {cfg.name} B={b} S=2048: prefill {prefill_ms:.2f}"
            f" ms per micro-batch, decode {decode_ms:.3f} ms per token step; "
            f"prefill device busy {bd_prefill['busy_ms']:.2f} of "
            f"{bd_prefill['wall_ms']:.2f} ms (idle share "
            f"{bd_prefill['idle_share']}), top {json.dumps(bd_prefill['top'])}"
            f"; decode step busy {bd_decode['busy_ms']:.3f} of "
            f"{bd_decode['wall_ms']:.3f} ms (idle share "
            f"{bd_decode['idle_share']}), top {json.dumps(bd_decode['top'])}")
        holder.clear()
    del engines, bank, session, eng
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the attention kernels at the served shapes: held against their
    # plain versions, then timed on the same inputs ----------------------
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, served_errs = {}, {}
    for name, (h, kv, dh) in TIER_HEADS.items():
        b, s, kv_len = 8, 2048, 1873 + MAX_NEW // 2
        q = torch.randn(b, s, h, dh, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, s, kv, dh, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, s, kv, dh, generator=gen, device=dev).bfloat16()
        e = check_close(f"flash_attention {name} served B={b} S={s} bf16",
                        fk.flash_attention(q, k, v),
                        fk.flash_attention_plain(q, k, v),
                        **ATTN_TOL["bf16"])
        served_errs[f"flash_attention {name}"] = e
        errs["flash_attention"] = max(errs["flash_attention"], e)
        bound, by = flash_bound_ms(b, s, h, kv, dh, 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rows[f"flash_attention {name}"] = dict(
            name="flash_attention", shape=[b, s, h, kv, dh],
            **kernel_ms(lambda: fk.flash_attention(q, k, v), 3,
                        "flash_attention"),
            plain_ms=event_time(lambda: fk.flash_attention_plain(q, k, v),
                                1, reps=3, warmup=1),
            library_ms=event_time(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 5),
            bound_ms=bound, bound_by=by)
        del q, qt
        qd = torch.randn(b, h, dh, generator=gen, device=dev).bfloat16()
        ck = torch.randn(b, s, kv * dh, generator=gen,
                         device=dev).bfloat16().view(b, s, kv, dh)
        cv = torch.randn(b, s, kv * dh, generator=gen,
                         device=dev).bfloat16().view(b, s, kv, dh)
        for n in sorted({kv_len, *served_kv[name]}):
            e = check_close(
                f"decode_attention {name} served B={b} kv_len={n} bf16",
                dk.decode_attention(qd, ck, cv, n),
                dk.decode_attention_plain(qd, ck, cv, n),
                **ATTN_TOL["bf16"])
            served_errs[f"decode_attention {name} kv_len={n}"] = e
            errs["decode_attention"] = max(errs["decode_attention"], e)
        mask = (torch.arange(s, device=dev) < kv_len)[None, :]
        bound, by = decode_bound_ms(b, kv_len, h, kv, dh, 2)
        plan = dk.split_plan(b, kv, kv_len, n_sm)
        rows[f"decode_attention {name}"] = dict(
            name="decode_attention", shape=[b, s, h, kv, dh, kv_len],
            splits=list(plan),
            **kernel_ms(lambda: dk.decode_attention(qd, ck, cv, kv_len), 50,
                        "decode_attention", 1 if plan[0] == 1 else 2),
            plain_ms=event_time(
                lambda: dk.decode_attention_plain(qd, ck, cv, kv_len), 20),
            library_ms=event_time(lambda: F.scaled_dot_product_attention(
                qd[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2),
                attn_mask=mask, enable_gqa=True), 20),
            bound_ms=bound, bound_by=by)
        del k, v, kt, vt, qd, ck, cv
    log(f"phase tiers: kernels == plain at the served shapes (B=8, "
        f"S=2048, bf16 within {ATTN_TOL['bf16']}; decode at kv_len 1881 "
        f"and the served {json.dumps({k: sorted(v) for k, v in served_kv.items()})}"
        f"): max abs err {json.dumps(served_errs)}")
    for name, row in rows.items():
        log(f"phase tiers times: {name}: {json.dumps(row)}")
    return dict(launches=launches, wall_s=wall, batches=batches,
                parity=parity, times=times, kernels=rows,
                served_errs=served_errs)


# -- phase recsys ---------------------------------------------------------------

def _seg_rows(gen, s: int, r: int, d: int, dtype, dev, pads: bool,
              offset: int = 0):
    """[S*r, D] rows (``offset`` elements past an aligned address) and
    sorted segment ids; with ``pads`` ~30% of rows and all of segment 0
    are -1."""
    import torch
    flat = torch.randn(s * r * d + offset, generator=gen, device=dev)
    rows = flat.to(dtype)[offset:].view(s * r, d)
    seg = torch.arange(s, device=dev, dtype=torch.int32).repeat_interleave(r)
    if pads:
        drop = torch.rand(s * r, generator=gen, device=dev) < 0.3
        seg = torch.where(drop, -1, seg).to(torch.int32)
        seg[:r] = -1
    return rows, seg


@contextlib.contextmanager
def plain_segment_sums():
    """The segment kernel's two wrappers swapped for their plain PyTorch
    versions on any device, for the run that holds the recsys path against
    the same path without the kernel."""
    from repro_torch.kernels.segment_reduce import kernel as sr
    saved = sr.segment_sum_sorted, sr.embedding_bag
    sr.segment_sum_sorted = (lambda rows, seg, s, r, seg_tile=8:
                             sr.segment_sum_sorted_plain(rows, seg, s, r))
    sr.embedding_bag = sr.embedding_bag_plain
    try:
        yield
    finally:
        sr.segment_sum_sorted, sr.embedding_bag = saved


def check_segment_kernels(dev, errs: dict) -> None:
    """segment_sum_sorted and embedding_bag vs their plain versions: the
    reference test's shapes (tests/test_kernels.py:78), D in (1, 10, 21,
    128) at r in (1, 39), pad rows, rows and tables that start one element
    past an aligned address (narrow loads), fp32 and bf16; the bag with -1
    pads, an all-pad bag and a bag with an id past the table (NaN, as the
    reference's gather makes it), sum and mean."""
    import torch
    from repro_torch.kernels.segment_reduce import kernel as sr
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    worst = {"fp32": 0.0, "bf16": 0.0}
    shapes = [(8, 4, 16), (16, 8, 32), (32, 2, 64)]
    shapes += [(64, r, d) for r in (1, 39) for d in (1, 10, 21, 128)]
    for dtype, tname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        tol = SEG_TOL[tname]
        for s, r, d in shapes:
            for pads, offset in ((False, 0), (True, 0), (True, 1)):
                rows, seg = _seg_rows(gen, s, r, d, dtype, dev, pads, offset)
                e = check_close(
                    f"segment_sum_sorted S={s} r={r} D={d} pads={pads} "
                    f"offset={offset} {tname}",
                    sr.segment_sum_sorted(rows, seg, s, r),
                    sr.segment_sum_sorted_plain(rows, seg, s, r), **tol)
                worst[tname] = max(worst[tname], e)
        for b, nnz, d in ((8, 5, 1), (64, 39, 10), (64, 26, 16),
                          (64, 16, 128), (4, 3, 21)):
            for offset in (0, 1):
                flat = torch.randn(5000 * d + offset, generator=gen,
                                   device=dev).to(dtype)
                table = flat[offset:].view(5000, d)
                ids = torch.randint(-1, 5000, (b, nnz), generator=gen,
                                    device=dev, dtype=torch.int32)
                ids[1] = -1
                ids[2, 0] = 5000                 # past the table: bag NaN
                for mean in (False, True):
                    got = sr.embedding_bag(table, ids, mean)
                    want = sr.embedding_bag_plain(table, ids, mean)
                    if got[1].any():
                        raise AssertionError("an all-pad bag is not 0")
                    if not (got[2].isnan().all() and want[2].isnan().all()):
                        raise AssertionError("a bag with an id past the "
                                             "table is not NaN")
                    rest = torch.arange(b, device=dev) != 2
                    e = check_close(
                        f"embedding_bag B={b} nnz={nnz} D={d} mean={mean} "
                        f"offset={offset} {tname}", got[rest], want[rest],
                        **tol)
                    worst[tname] = max(worst[tname], e)
    errs["segment_sum_sorted"] = worst["fp32"]
    log(f"phase kernels: segment_sum_sorted / embedding_bag == plain at "
        f"(S, r, D) in {shapes}, pads, misaligned rows, bags with -1 pads: "
        f"max abs err fp32 {worst['fp32']:.3g} ({SEG_TOL['fp32']}), bf16 "
        f"{worst['bf16']:.3g} ({SEG_TOL['bf16']})")
    torch.cuda.synchronize()


def seg_bound_ms(s: int, r: int, d: int, elem: int,
                 rows_read: int) -> tuple[float, str]:
    """Bytes: the ``rows_read`` rows (handed over, or gathered from the
    table) read once, the [S*r] int32 ids read, [S, D] written.
    Operations: one add per row element read, at the fp32 rate."""
    nbytes = rows_read * d * elem + s * r * 4 + s * d * elem
    ops = rows_read * d
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def deepfm_logit_bound(params: dict, cfg, sparse, logits):
    """Per-row bound on |kernel path - plain path| of deepfm logits. The
    two differ only in the order of the three F-term fp32 sums (fm1, sum
    v_d, sum v_d^2); the deep tower is the same ops on the same inputs. A
    sum of F terms lies within g(F-1) sum|x| of the exact sum (g(n) =
    n u / (1 - n u), u = 2^-24), so two orders differ by at most
    e(x) = 2 g(F-1) sum|x|. fm2 = 1/2 sum_d (s_d^2 - q_d) then moves by at
    most 1/2 sum_d (2 |s_d| e_d + e_d^2 + e'_d), plus its own d + 2
    roundings on either side, 2 g(d+2) 1/2 sum_d (s_d^2 + q_d); the two
    final adds round fm1 + fm2 + deep: 4 u (|fm1| + |fm2| + |logit|)."""
    from repro_torch.models import recsys as rec

    def g(n):
        return n * FP32_U / (1 - n * FP32_U)

    gids = rec.to_global_ids(cfg, sparse)
    f, d = gids.shape[1], cfg.embed_dim
    v = params["tables"][gids].double()                       # [B, F, d]
    first = params["fm"]["w1"][gids][..., 0].double()         # [B, F]
    s, q = v.sum(1), (v * v).sum(1)
    e_first = 2 * g(f - 1) * first.abs().sum(1)
    e_s = 2 * g(f - 1) * v.abs().sum(1)
    e_q = 2 * g(f - 1) * q
    fm1, fm2 = first.sum(1), 0.5 * (s * s - q).sum(1)
    e_fm2 = 0.5 * (2 * (s.abs() + e_s) * e_s + e_q).sum(1) \
        + g(d + 2) * (s * s + q).sum(1)
    logit = logits.to(v.device).double().abs()
    return e_first + e_fm2 + 4 * FP32_U * (fm1.abs() + fm2.abs() + logit)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_recsys(dev, errs: dict) -> dict:
    """The recsys routing path at full deepfm / dcn-v2 width: the example
    (``repro_torch.examples.recsys_routing.main``) routes B=512 requests
    against C=1,000,000 candidates and serves each with its tier's ranker;
    launches counted over it; held against the same path with the plain
    segment sums; the kernel at the served shapes; ranker times."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import dcn_v2, deepfm
    from repro_torch.examples import recsys_routing as example
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.segment_reduce import kernel as sr
    from repro_torch.models import recsys as rec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    small_cfg, large_cfg = deepfm.CONFIG, dcn_v2.CONFIG
    small = rec.init_params(torch.Generator(device=dev).manual_seed(SEED + 10),
                            small_cfg, dev)
    large = rec.init_params(torch.Generator(device=dev).manual_seed(SEED + 11),
                            large_cfg, dev)
    torch.cuda.synchronize()
    gib = {c.name: sum(t.numel() * t.element_size() for t in _leaves(p))
           / 2 ** 30 for c, p in ((small_cfg, small), (large_cfg, large))}
    log(f"phase recsys: deepfm ({small_cfg.padded_vocab:,} x "
        f"{small_cfg.embed_dim} table) and dcn-v2 ({large_cfg.padded_vocab:,}"
        f" x {large_cfg.embed_dim}) at full width, fp32 weights "
        f"{json.dumps(gib)} GiB, made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    b, c, k = RECSYS["b"], RECSYS["c"], RECSYS["k"]
    run = dict(device=dev, small_cfg=small_cfg, large_cfg=large_cfg,
               n_req=b, n_cand=c, top_k=k, params=(small, large), seed=SEED,
               verbose=False)

    # ---- the main path: launches counted from here ----------------------
    cuda_build.reset_launches()
    t1 = time.perf_counter()
    out = example.main(**run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(cuda_build.LAUNCHES)
    # ---- end of the main path -------------------------------------------
    want = {name: 0 for name in launches}
    want.update(embedding_bag=1, segment_sum_sorted=1, skew_metrics=1)
    log(f"phase recsys: main path (retrieval_scores [{b}, {c:,}] -> top-{k}"
        f" -> calibrate_threshold -> build -> route -> deepfm / dcn-v2 "
        f"forward) in {wall:.2f} s; launches {json.dumps(launches)}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}: one "
                             f"embedding_bag per user_embedding, one "
                             f"segment_sum_sorted per deepfm forward, none "
                             f"in dcn-v2's, one skew_metrics per batch")
    tiers, diff, theta = out["tiers"], out["difficulty"], out["theta"]
    share = float((tiers > 0).mean())
    if abs(share - RECSYS["budget"]) > CAL_TOL:
        raise AssertionError(f"escalated share {share} vs budget "
                             f"{RECSYS['budget']} (tolerance {CAL_TOL})")
    logits = out["logits"]
    if tuple(out["scores_desc"].shape) != (b, k) or \
            not np.isfinite(logits).all():
        raise AssertionError("scores or logits malformed")
    log(f"phase recsys: entropy threshold {theta:.6f}; escalated "
        f"{int((tiers > 0).sum())} of {b} ({share:.4f}, budget "
        f"{RECSYS['budget']} +- {CAL_TOL}); mean entropy served-small "
        f"{diff[tiers == 0].mean():.5f} vs escalated "
        f"{diff[tiers > 0].mean():.5f}")

    # ---- the same path with the plain segment sums -----------------------
    before = dict(cuda_build.LAUNCHES)
    with plain_segment_sums():
        plain = example.main(**run)
    if any(cuda_build.LAUNCHES[name] != before[name]
           for name in ("embedding_bag", "segment_sum_sorted")):
        raise AssertionError("the plain run launched a segment kernel")
    check_close("recsys scores_desc vs plain", out["scores_desc"],
                plain["scores_desc"], **E2E_TOL)
    if abs(plain["theta"] - theta) > E2E_TOL["atol"] + \
            E2E_TOL["rtol"] * abs(theta):
        raise AssertionError(f"theta {theta} vs plain {plain['theta']}")
    check_close("recsys difficulty vs plain", diff, plain["difficulty"],
                **E2E_TOL)
    # a row can change tier only if its difficulty and the threshold moved
    # it across: tiers must agree outside that measured band
    band = float(np.abs(diff - plain["difficulty"]).max()) + \
        abs(plain["theta"] - theta)
    near = np.abs(diff - theta) <= band
    wrong = (tiers != plain["tiers"]) & ~near
    if wrong.any():
        raise AssertionError(f"recsys tiers differ from the plain path in "
                             f"rows {np.flatnonzero(wrong)[:10].tolist()}")
    user_fields, cand_ids, dense, sparse = out["requests"]
    r0, r1 = out["rows"][0], out["rows"][1]
    user0 = torch.as_tensor(user_fields[r0], device=dev)
    with plain_segment_sums():
        want0 = rec.forward(small, small_cfg, {"sparse": user0})
    bound0 = deepfm_logit_bound(small, small_cfg, user0,
                                want0).cpu().numpy()
    want0 = want0.cpu().numpy()
    diff0 = np.abs(logits[r0].astype(np.float64) - want0)
    if (diff0 > bound0).any():
        raise AssertionError(f"deepfm logits outside the derived bound: "
                             f"max diff {diff0.max()}, bound at that row "
                             f"{bound0[diff0.argmax()]}")
    want1 = rec.forward(large, large_cfg, {"dense": dense[r1],
                                           "sparse": sparse[r1]}
                        ).cpu().numpy()
    if not np.array_equal(logits[r1], want1):
        raise AssertionError("dcn-v2 logits differ between two runs of the "
                             "same ops on the same inputs")
    parity = dict(theta=theta, theta_plain=plain["theta"], band=band,
                  rows_near_theta=int(near.sum()),
                  tiers_differ=int((tiers != plain["tiers"]).sum()),
                  deepfm_max_abs=float(diff0.max()),
                  deepfm_bound_min=float(bound0.min()),
                  deepfm_max_share_of_bound=float((diff0 / bound0).max()),
                  dcn_equal=True)
    log(f"phase recsys: kernel path vs plain segment sums on the card "
        f"(scores and difficulty {E2E_TOL}; tiers equal outside the "
        f"measured band around theta; deepfm logits inside the derived bound; dcn-v2 "
        f"logits equal): {json.dumps(parity)}")
    del plain
    gc.collect()

    # ---- the kernel at the served shapes: held against its plain version,
    # then timed beside it, the library call and its bound ----------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    session = out["session"]
    user = torch.as_tensor(user_fields, device=dev)
    cand = torch.as_tensor(cand_ids, device=dev)
    served_errs, rows = {}, {}
    shapes = {"serve_p99": (b, small_cfg.n_sparse, small),
              "serve_bulk": (RECSYS["bulk"], small_cfg.n_sparse, small),
              "production": RECSYS["production"][:2] + (None,)}
    for name, (s, r, params) in shapes.items():
        if params is None:
            d, n_rows = RECSYS["production"][2:]
            table = torch.randn(n_rows, d, generator=gen, device=dev)
            ids = torch.randint(0, n_rows, (s, r), generator=gen,
                                device=dev, dtype=torch.int32)
        else:
            table = params["tables"]
            sp = user if s == b else torch.randint(
                0, min(small_cfg.vocab_sizes), (s, r), generator=gen,
                device=dev)
            ids = rec.to_global_ids(small_cfg, sp).to(torch.int32)
        d = table.shape[1]
        seg = torch.arange(s, device=dev, dtype=torch.int32
                           ).repeat_interleave(r)
        lengths = torch.full((s,), r, device=dev, dtype=torch.int64)
        inputs = {"rows": table[ids.long()].reshape(s * r, d)}
        if params is not None:   # the deepfm forward's [B*F, 1 + 2d] rows
            emb = inputs["rows"].view(s, r, d)
            inputs["rows 1+2d"] = torch.cat(
                [params["fm"]["w1"][ids.long()], emb, emb * emb],
                -1).reshape(s * r, 1 + 2 * d)
            del emb
        cases = {"bag": (lambda: sr.embedding_bag(table, ids),
                         lambda: sr.embedding_bag_plain(table, ids),
                         lambda: F.embedding_bag(ids, table, mode="sum"),
                         "F.embedding_bag", d)}
        for mode, x in inputs.items():
            cases[mode] = (
                lambda x=x: sr.segment_sum_sorted(x, seg, s, r),
                lambda x=x: sr.segment_sum_sorted_plain(x, seg, s, r),
                lambda x=x: torch.segment_reduce(x, "sum", lengths=lengths),
                "torch.segment_reduce", x.shape[1])
        for mode, (fn, plain_fn, lib, lib_name, width) in cases.items():
            key = f"{name} {mode}"
            want_out = plain_fn()
            e = check_close(f"segment kernel {key}", fn(), want_out,
                            **SEG_TOL["fp32"])
            e_lib = check_close(f"library {lib_name} {key}", lib(),
                                want_out, **SEG_TOL["fp32"])
            del want_out
            served_errs[key] = e
            errs["segment_sum_sorted"] = max(errs["segment_sum_sorted"], e)
            bound, by = seg_bound_ms(s, r, width, 4, s * r)
            iters = 20 if s * r * width > 1e7 else 200
            dev_ms, n_k = kernel_device_ms(fn, iters, "segment_sum_kernel")
            if dev_ms is not None and n_k != 1:
                raise AssertionError(f"segment kernel {key}: {n_k} kernels "
                                     f"per call in the trace, 1 expected")
            ev = event_time(fn, iters)
            rows[key] = dict(
                name="embedding_bag" if mode == "bag"
                else "segment_sum_sorted", shape=[s, r, width],
                ms=ev if dev_ms is None else dev_ms, event_ms=ev,
                ms_from="cuda events" if dev_ms is None else "cupti trace",
                kernels_per_call=n_k,
                plain_ms=event_time(plain_fn, max(iters // 10, 2)),
                library_ms=event_time(lib, iters), library=lib_name,
                library_err=e_lib, bound_ms=bound, bound_by=by)
            log(f"phase recsys times: {key}: {json.dumps(rows[key])}")
        del inputs, table, ids, cases
        gc.collect()
    log(f"phase recsys: kernel == plain at the served shapes (fp32 "
        f"{SEG_TOL['fp32']}): max abs err {json.dumps(served_errs)}")

    # ---- end to end: the routing batch and each ranker's forward --------
    def route_batch():
        scores = rec.retrieval_scores(small, small_cfg, {"sparse": user},
                                      cand)
        return session.route(torch.topk(scores, k, dim=1).values)

    e2e = {f"route B={b} C={c}": dict(ms=sync_time(route_batch, 5),
                                      device=device_breakdown(route_batch,
                                                              3))}
    vocab = torch.as_tensor(large_cfg.vocab_sizes, device=dev)
    for shape, n in (("serve_p99", b), ("serve_bulk", RECSYS["bulk"])):
        batches = {small_cfg.name: {"sparse": torch.randint(
            0, min(small_cfg.vocab_sizes), (n, small_cfg.n_sparse),
            generator=gen, device=dev)},
            large_cfg.name: {
            "dense": torch.randn(n, large_cfg.n_dense, generator=gen,
                                 device=dev),
            "sparse": (torch.rand(n, large_cfg.n_sparse, generator=gen,
                                  device=dev) * vocab).long()}}
        for cfg, params in ((small_cfg, small), (large_cfg, large)):
            def fn(params=params, cfg=cfg):
                return rec.forward(params, cfg, batches[cfg.name])
            if not torch.isfinite(fn()).all():
                raise AssertionError(f"{cfg.name} {shape}: non-finite logits")
            e2e[f"{cfg.name} forward {shape} B={n}"] = dict(
                ms=sync_time(fn, 5), device=device_breakdown(fn, 3))
        del batches
    for name, row in e2e.items():
        bd = row["device"]
        log(f"phase recsys e2e: {name}: {row['ms']:.4f} ms; device busy "
            f"{bd['busy_ms']:.4f} of {bd['wall_ms']:.4f} ms (idle share "
            f"{bd['idle_share']}); top {json.dumps(bd['top'])}")
    peak = (torch.cuda.max_memory_allocated(dev) - base_mem) / 2 ** 30
    log(f"phase recsys: peak device memory of the phase {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    result = dict(launches=launches, wall_s=wall, parity=parity,
                  kernels=rows, e2e=e2e, served_errs=served_errs,
                  peak_gib=peak)
    del small, large, out, session, user, cand
    gc.collect()
    torch.cuda.empty_cache()
    return result


def kernel_lines(server: dict, times: dict, errs: dict,
                 tiers: dict, recsys: dict) -> list[dict]:
    """One entry per kernel for the JSON result line."""
    replaces = {
        "skew_metrics": ("src/repro_torch/kernels/csrc/skew_metrics.cu",
                         "src/repro/kernels/skew_metrics/kernel.py:84",
                         "skew_metrics B=256 K=100"),
        "triple_score_batched": (
            "src/repro_torch/kernels/csrc/triple_score.cu",
            "src/repro/kernels/triple_score/kernel.py:83",
            "triple_score_batched paper B=256"),
        "triple_score": ("src/repro_torch/kernels/csrc/triple_score.cu",
                         "src/repro/kernels/triple_score/kernel.py:48",
                         "triple_score kgqa retrieve Q=1"),
    }
    kernels = []
    for name, (source, ref, row) in replaces.items():
        r = times["kernels"][row]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=ref,
            launches=server["launches"][name], max_abs_err=errs[name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            call_ms=r["call_ms"], event_ms=r["event_ms"],
            ms_from=r["ms_from"], kernels_per_call=r["kernels_per_call"],
            shape=r["shape"], launches_by_path={p: c[name] for p, c in
                              server["per_path"].items()}))
    # the tiers' kernels: launches from phase tiers' main path, times at
    # the large tier's served shape (B=8, S=2048)
    for name, source, ref in (
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:78"),
            ("decode_attention",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:68")):
        r = tiers["kernels"][f"{name} internlm2-20b"]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=ref,
            launches=tiers["launches"][name], max_abs_err=errs[name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            event_ms=r["event_ms"], ms_from=r["ms_from"],
            kernels_per_call=r["kernels_per_call"], shape=r["shape"],
            **({"splits": r["splits"]} if "splits" in r else {})))
    # the recsys kernel: one source, two launchers (rows handed over, rows
    # gathered from the table); launches of both from phase recsys's main
    # path, times at the reference bench's production shape
    # (benchmarks/kernel_bench.py:108), rows handed over
    rk = recsys["kernels"]
    r, bag = rk["production rows"], rk["production bag"]
    kernels.append(dict(
        name="segment_sum_sorted", route="cuda",
        source="src/repro_torch/kernels/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce/kernel.py:46",
        launches=recsys["launches"]["segment_sum_sorted"]
        + recsys["launches"]["embedding_bag"],
        max_abs_err=errs["segment_sum_sorted"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        library=r["library"], event_ms=r["event_ms"], ms_from=r["ms_from"],
        shape=r["shape"],
        launches_by_wrapper={k: recsys["launches"][k] for k in
                             ("segment_sum_sorted", "embedding_bag")},
        bag_ms=bag["ms"], bag_plain_ms=bag["plain_ms"],
        bag_bound_ms=bag["bound_ms"], bag_library_ms=bag["library_ms"],
        bag_library=bag["library"],
        kernels_per_call=r["kernels_per_call"]))
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain checks")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.modules["jax"] = None       # the port must not need either
    sys.modules["repro"] = None
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the GPU only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    errs: dict[str, float] = {}
    t0 = time.perf_counter()
    info = phase_device(dev)
    phase_kernels(dev, errs)
    if args.kernels_only:
        log(f"kernels-only run done in {time.perf_counter() - t0:.1f} s")
        return 0
    server = phase_server(dev, errs)
    times = phase_times(dev, server)
    recsys = phase_recsys(dev, errs)
    tiers = phase_tiers(dev, errs, server)
    kernels = kernel_lines(server, times, errs, tiers, recsys)
    log(f"run took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
