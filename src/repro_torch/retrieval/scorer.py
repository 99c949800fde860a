"""SubgraphRAG-style triple scorer (the retrieval stage SkewRoute reads).

A lightweight MLP scores each candidate triple against the query
(paper §2: "SubgraphRAG employs a lightweight MLP to score independent
triples"). Features per triple: [head_emb, rel_emb, tail_emb, DDE, SIM]:
DDE is the directional-distance encoding of head/tail from the topic
entity (one-hot over hop distance, SubgraphRAG §3); SIM are four
query-triple dot products (q·h, q·r, q·t, q·(h+r)) — the role the frozen
text-encoder similarity plays in SubgraphRAG's feature stack.

The weight layout matches `repro_torch.kernels.triple_score` exactly (W1
split into triple-side and query-side halves) so the fused kernel is a
drop-in for the serving path. This module holds the serving half of the
reference's scorer; the training loop (BCE loss, Adam) is ported with
the training slice. Weights trained by the reference cross over with
:func:`params_from_jax`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.kernels.device import DeviceLike, resolve_device
from repro_torch.retrieval.kg import KnowledgeGraph
from repro_torch.retrieval.synthetic import Query, candidate_edges

MAX_DDE_HOPS = 4  # distance buckets: 0..3, >=4/unreachable

PARAM_NAMES = ("w1_t", "w1_q", "b1", "w2", "b2")


@dataclasses.dataclass(frozen=True)
class ScorerConfig:
    d_emb: int = 32
    d_hidden: int = 128
    lr: float = 3e-3
    top_k: int = 100

    @property
    def d_triple(self) -> int:
        return 3 * self.d_emb + 2 * (MAX_DDE_HOPS + 1) + 4  # +SIM features

    @property
    def d_query(self) -> int:
        return self.d_emb


def init_scorer(generator: torch.Generator, cfg: ScorerConfig,
                device: DeviceLike = None) -> dict:
    """He-initialised scorer weights drawn from ``generator`` (a CPU
    ``torch.Generator``), placed on ``device`` (default: CUDA)."""
    dev = resolve_device(device)
    dt, dq, h = cfg.d_triple, cfg.d_query, cfg.d_hidden

    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float32)

    params = {
        "w1_t": normal(dt, h) * (2 / dt) ** 0.5,
        "w1_q": normal(dq, h) * (2 / dq) ** 0.5,
        "b1": torch.zeros(h),
        "w2": normal(h, 1) * (2 / h) ** 0.5,
        "b2": torch.zeros(1),
    }
    return {k: v.to(dev) for k, v in params.items()}


def params_from_jax(params: Mapping[str, np.ndarray],
                    device: DeviceLike = None) -> dict:
    """Carry scorer weights made by the reference package across: each
    array (numpy, or anything ``np.asarray`` reads) becomes a float32
    tensor on ``device`` (default: CUDA)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(params[k]), dtype=torch.float32,
                            device=dev)
            for k in PARAM_NAMES}


def dde_features(kg: KnowledgeGraph, topic: int, edge_ids: np.ndarray) -> np.ndarray:
    """One-hot hop distance of head & tail from the topic entity."""
    dist = kg.distances_from(topic, MAX_DDE_HOPS)
    def onehot(node):
        d = min(dist.get(int(node), MAX_DDE_HOPS), MAX_DDE_HOPS)
        v = np.zeros(MAX_DDE_HOPS + 1, np.float32)
        v[d] = 1.0
        return v
    h = np.stack([onehot(kg.heads[e]) for e in edge_ids])
    t = np.stack([onehot(kg.tails[e]) for e in edge_ids])
    return np.concatenate([h, t], axis=1)


def triple_features(kg: KnowledgeGraph, ent: np.ndarray, rel: np.ndarray,
                    q: Query, edge_ids: np.ndarray) -> np.ndarray:
    h, r, t = (ent[kg.heads[edge_ids]], rel[kg.rels[edge_ids]],
               ent[kg.tails[edge_ids]])
    d = h.shape[1]
    qv = q.query_emb / np.sqrt(d)
    sim = np.stack([h @ qv, r @ qv, t @ qv, (h + r) @ qv], axis=1)
    return np.concatenate([h, r, t, dde_features(kg, q.topic, edge_ids),
                           sim], axis=1).astype(np.float32)


def score_fn(params: dict, triples: torch.Tensor,
             query: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch scoring path (oracle of the fused kernel).
    [N,Dt],[Dq] -> [N]."""
    h = torch.relu(triples @ params["w1_t"]
                   + query @ params["w1_q"] + params["b1"])
    return (h @ params["w2"])[:, 0] + params["b2"][0]


def retrieve(params: dict, kg: KnowledgeGraph, ent, rel, q: Query,
             cfg: ScorerConfig, max_cands: int = 512,
             seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Top-K retrieval for one query -> (edge_ids desc-by-score, scores).

    Scoring runs on the weights' device through the fused triple-score
    kernel (one query over its own candidate set: the shared-candidate
    ``triple_score`` with Q=1)."""
    from repro_torch.kernels.triple_score import ops as ts_ops

    dev = params["w1_t"].device
    edges = candidate_edges(kg, q, max_edges=max_cands, seed=seed)
    feats = triple_features(kg, ent, rel, q, edges)
    scores = ts_ops.triple_score(
        torch.as_tensor(feats, device=dev),
        torch.as_tensor(q.query_emb[None], device=dev),
        *kernel_weights(params))[0].cpu().numpy()
    k = min(cfg.top_k, len(edges))
    order = np.argsort(-scores)[:k]
    probs = 1.0 / (1.0 + np.exp(-scores[order]))  # paper scores are [0,1]
    return edges[order], probs.astype(np.float32)


# -- batched device-side retrieval (feeds the fused routing path) -------------


def kernel_weights(params: dict) -> tuple:
    """The scorer weights in the triple-score kernel's argument order —
    the drop-in contract made explicit (and the one place that would
    break loudly if either layout ever drifted)."""
    return tuple(params[k] for k in PARAM_NAMES)


def batch_triple_features(kg: KnowledgeGraph, ent, rel,
                          queries: list, max_cands: int = 512,
                          seed: int = 0
                          ) -> tuple[np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
    """Stack per-query candidate features into one ragged batch.

    Returns ``(feats [B, N, Dt], query_embs [B, Dq], edge_ids [B, N],
    n_cand [B])`` where N is the largest candidate count in the batch;
    rows are zero-padded past ``n_cand`` (edge_ids pad with -1). This is
    the host-side data-pipeline half; everything after it — scoring,
    top-k, skew, tier decision — runs on the device
    (`repro_torch.core.router.route_retrieved`).
    """
    per_query = []
    for q in queries:
        edges = candidate_edges(kg, q, max_edges=max_cands, seed=seed)
        per_query.append((edges, triple_features(kg, ent, rel, q, edges)))
    n = max(len(edges) for edges, _ in per_query)
    dt = per_query[0][1].shape[1]
    b = len(queries)
    feats = np.zeros((b, n, dt), np.float32)
    edge_ids = np.full((b, n), -1, np.int64)
    n_cand = np.zeros(b, np.int32)
    for i, (edges, f) in enumerate(per_query):
        feats[i, :len(edges)] = f
        edge_ids[i, :len(edges)] = edges
        n_cand[i] = len(edges)
    qembs = np.stack([q.query_emb for q in queries]).astype(np.float32)
    return feats, qembs, edge_ids, n_cand


def retrieve_batch(params: dict, kg: KnowledgeGraph, ent, rel,
                   queries: list, cfg: ScorerConfig, max_cands: int = 512,
                   seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched top-K retrieval on the weights' device: the fused
    ``triple_score_batched`` kernel scores every query's candidates and
    a device top-k picks each query's best — the batched counterpart of
    :func:`retrieve` (same edge ids and probs per query).

    Returns ``(edge_ids [B, K], probs [B, K], n_valid [B])``; rows with
    fewer than K candidates pad edge_ids with -1 / probs with 0 past
    ``n_valid``.
    """
    from repro_torch.kernels.triple_score import ops as ts_ops

    dev = params["w1_t"].device
    feats, qembs, edge_ids, n_cand = batch_triple_features(
        kg, ent, rel, queries, max_cands=max_cands, seed=seed)
    n = feats.shape[1]
    logits = ts_ops.triple_score_batched(
        torch.as_tensor(feats, device=dev), torch.as_tensor(qembs, device=dev),
        *kernel_weights(params))
    nc = torch.as_tensor(n_cand, device=dev)
    col = torch.arange(n, device=dev)
    logits = torch.where(col[None, :] < nc[:, None], logits, -torch.inf)
    k = min(cfg.top_k, n)
    vals, idx = torch.topk(logits, k, dim=1)
    idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
    n_valid = np.minimum(n_cand, k).astype(np.int32)
    with np.errstate(over="ignore"):
        probs = np.where(np.isfinite(vals),
                         1.0 / (1.0 + np.exp(-vals)), 0.0).astype(np.float32)
    out_edges = np.take_along_axis(edge_ids, idx, axis=1)
    out_edges[np.arange(k)[None, :] >= n_valid[:, None]] = -1
    return out_edges, probs, n_valid

