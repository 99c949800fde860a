"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: each test skips where there is no CUDA device (as
on a CPU-only host); on the GPU host run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only the port is installed. Tolerances:
skew metrics atol 1e-5 + rtol 1e-5 with cumulative-k exact; the scorer
1e-5 at Dt=110 (the reference's bars).
"""

import numpy as np
import pytest
import torch

from repro_torch.api import RouteSpec, build, make_backend
from repro_torch.kernels import cuda_build
from repro_torch.kernels.skew_metrics import kernel as sk
from repro_torch.kernels.triple_score import kernel as ts
from repro_torch.retrieval import scorer as sc

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
