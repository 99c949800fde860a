"""Fanout neighbor sampler (GraphSAGE-style) over the CSR triple store.

Shared by (a) the GNN ``minibatch_lg`` shape — fanout-(15,10) sampled
subgraphs padded to static sizes — and (b) KG retrieval candidate pooling.
Host-side numpy (like real loaders); outputs are statically-shaped padded arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.retrieval.kg import KnowledgeGraph


@dataclasses.dataclass
class SampledSubgraph:
    """Padded, statically-shaped sampled subgraph.

    node_ids: [n_nodes_max] global ids (-1 pad); src/dst: [n_edges_max]
    LOCAL indices (dummy = n_valid slot handled by the model); seed_mask
    marks the seed rows (loss rows).
    """
    node_ids: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    n_valid_nodes: int
    seed_mask: np.ndarray


def sample_subgraph(kg: KnowledgeGraph, seeds: np.ndarray,
                    fanouts: tuple[int, ...],
                    n_nodes_max: int, n_edges_max: int,
                    seed: int = 0) -> SampledSubgraph:
    rng = np.random.default_rng(seed)
    local = {int(s): i for i, s in enumerate(seeds)}
    node_list = [int(s) for s in seeds]
    src_l: list[int] = []
    dst_l: list[int] = []
    frontier = list(seeds)
    for fanout in fanouts:
        nxt = []
        for node in frontier:
            edges = kg.out_edges(int(node))
            if len(edges) == 0:
                continue
            pick = rng.choice(edges, size=min(fanout, len(edges)),
                              replace=False)
            for ei in pick:
                t = int(kg.tails[ei])
                if t not in local:
                    if len(node_list) >= n_nodes_max:
                        continue
                    local[t] = len(node_list)
                    node_list.append(t)
                    nxt.append(t)
                if len(src_l) < n_edges_max:
                    # message flows neighbor -> node (dst = aggregating node)
                    src_l.append(local[t])
                    dst_l.append(local[int(node)])
        frontier = nxt
    n_valid = len(node_list)
    dummy = n_valid  # model appends a dummy row at n_valid
    node_ids = np.full(n_nodes_max, -1, np.int32)
    node_ids[:n_valid] = node_list
    src = np.full(n_edges_max, dummy, np.int32)
    dst = np.full(n_edges_max, dummy, np.int32)
    src[: len(src_l)] = src_l
    dst[: len(dst_l)] = dst_l
    seed_mask = np.zeros(n_nodes_max, bool)
    seed_mask[: len(seeds)] = True
    return SampledSubgraph(node_ids=node_ids, src=src, dst=dst,
                           n_valid_nodes=n_valid, seed_mask=seed_mask)
