"""SkewRoute for recsys ranking: route each request between a small and a
large ranker on the skewness of its candidate scores, then serve it.

The counterpart of the reference's ``examples/recsys_routing.py``: the
small DeepFM ranker scores candidate items per request (the users' field
embeddings reduced by the port's ``segment_reduce`` kernel, then one
matmul); the top-K scores calibrate an entropy threshold for a 30%
large-ranker budget; a session built from a ``RouteSpec`` routes the
batch (the ``skew_metrics`` kernel). Confident requests (skewed scores,
one clear winner) are served by DeepFM, ambiguous ones (flat scores)
escalate to the large DCN-v2 ranker.

    PYTHONPATH=src python -m repro_torch.examples.recsys_routing --device cpu

Without ``--device`` it runs on the CUDA device. The defaults are the
reference example's narrow DeepFM (64 requests x 100 candidates) and a
narrow DCN-v2; ``main`` takes the full-width configs as well
(``repro_torch.configs.deepfm`` / ``dcn_v2``).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.api import RouteSpec, build
from repro_torch.core import calibrate_threshold
from repro_torch.kernels.device import DeviceLike, resolve_device, to_numpy
from repro_torch.models import recsys as rec

SMALL_CFG = rec.RecsysConfig(
    name="deepfm-small", model="deepfm", n_dense=0, n_sparse=8,
    embed_dim=10, vocab_sizes=(2000,) * 8, deep_mlp=(64, 64),
    interaction="fm")
LARGE_CFG = rec.RecsysConfig(
    name="dcnv2-large", model="dcn_v2", n_dense=13, n_sparse=26,
    embed_dim=16, vocab_sizes=(500,) * 26, deep_mlp=(64, 32),
    n_cross_layers=3, interaction="cross")
BUDGET = 0.3


def make_requests(rng: np.random.Generator, small_cfg: rec.RecsysConfig,
                  large_cfg: rec.RecsysConfig, n_req: int, n_cand: int):
    """Each request's user fields (the small ranker's sparse ids) and the
    candidate rows, drawn as the reference example draws them, then the
    large ranker's dense and sparse features."""
    user_fields = rng.integers(0, min(small_cfg.vocab_sizes),
                               (n_req, small_cfg.n_sparse))
    cand_ids = rng.integers(0, small_cfg.padded_vocab, (n_cand,))
    dense = rng.normal(0, 1, (n_req, large_cfg.n_dense)).astype(np.float32)
    sparse = rng.integers(0, np.asarray(large_cfg.vocab_sizes),
                          (n_req, large_cfg.n_sparse))
    return user_fields, cand_ids, dense, sparse


def main(device: DeviceLike = None,
         small_cfg: rec.RecsysConfig = SMALL_CFG,
         large_cfg: rec.RecsysConfig = LARGE_CFG,
         n_req: int = 64, n_cand: int = 100, top_k: int = 100,
         params: Optional[tuple] = None, seed: int = 0,
         verbose: bool = True) -> dict:
    """Score, calibrate, route and serve ``n_req`` requests against
    ``n_cand`` candidates. ``params``: (small, large) ranker weights, else
    made from ``seed`` on the device. Returns every intermediate (the
    requests as ``(user_fields, cand_ids, dense, sparse)``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if params is None:
        params = (rec.init_params(seed, small_cfg, dev),
                  rec.init_params(seed + 1, large_cfg, dev))
    small, large = params
    user_fields, cand_ids, dense, sparse = make_requests(
        rng, small_cfg, large_cfg, n_req, n_cand)
    user = torch.as_tensor(user_fields, device=dev)

    scores = rec.retrieval_scores(small, small_cfg, {"sparse": user},
                                  torch.as_tensor(cand_ids, device=dev))
    k = min(top_k, n_cand)
    scores_desc = torch.topk(scores, k, dim=1).values       # descending
    theta = calibrate_threshold(scores_desc, target_large_ratio=BUDGET,
                                metric="entropy")
    session = build(RouteSpec(metric="entropy", thresholds=(theta,),
                              top_k=k,
                              tier_names=(small_cfg.name, large_cfg.name)),
                    device=dev)
    res = session.route(scores_desc)
    escalate = res.tiers > 0

    # each request served by the ranker of its tier
    logits = np.zeros(n_req, np.float32)
    rows = {0: np.flatnonzero(~escalate), 1: np.flatnonzero(escalate)}
    if len(rows[0]):
        idx = torch.as_tensor(rows[0], device=dev)
        logits[rows[0]] = to_numpy(rec.forward(
            small, small_cfg, {"sparse": user[idx]}))
    if len(rows[1]):
        logits[rows[1]] = to_numpy(rec.forward(
            large, large_cfg, {"dense": dense[rows[1]],
                               "sparse": sparse[rows[1]]}))

    ent = res.difficulty  # metric="entropy": difficulty IS score-entropy
    out = dict(theta=theta, tiers=res.tiers, difficulty=ent,
               escalated=int(escalate.sum()), logits=logits,
               scores_desc=scores_desc, rows=rows, session=session,
               requests=(user_fields, cand_ids, dense, sparse))
    if verbose:
        print(f"requests: {n_req}; escalated to the large ranker: "
              f"{escalate.sum()} ({escalate.mean():.0%}; budget "
              f"{BUDGET:.0%})")
        print(f"mean score-entropy served-small: {ent[~escalate].mean():.3f}"
              f" vs escalated: {ent[escalate].mean():.3f}")
    if not ent[escalate].mean() > ent[~escalate].mean():
        raise AssertionError("escalated requests must have flatter scores")
    if verbose:
        print(f"served: {len(rows[0])} by {small_cfg.name}, {len(rows[1])} "
              f"by {large_cfg.name}; logits finite: "
              f"{bool(np.isfinite(logits).all())}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda)")
    main(device=ap.parse_args().device)
