"""Knowledge-graph triple store with CSR adjacency.

Triples are (head, relation, tail) int32 arrays (Freebase-style). The CSR
layout (edges sorted by head + offsets) supports O(1) per-entity
neighborhood slicing for k-hop retrieval and the fanout neighbor sampler
shared with the GNN minibatch shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class KnowledgeGraph:
    heads: np.ndarray        # [E] int32
    rels: np.ndarray         # [E] int32
    tails: np.ndarray        # [E] int32
    n_entities: int
    n_relations: int
    # CSR over heads (built by `build`)
    order: np.ndarray = None       # edge permutation sorted by head
    offsets: np.ndarray = None     # [n_entities + 1]

    @classmethod
    def build(cls, heads, rels, tails, n_entities, n_relations) -> "KnowledgeGraph":
        heads = np.asarray(heads, np.int32)
        rels = np.asarray(rels, np.int32)
        tails = np.asarray(tails, np.int32)
        order = np.argsort(heads, kind="stable").astype(np.int32)
        counts = np.bincount(heads, minlength=n_entities)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(heads, rels, tails, int(n_entities), int(n_relations),
                   order, offsets)

    @property
    def n_triples(self) -> int:
        return len(self.heads)

    def out_edges(self, entity: int) -> np.ndarray:
        """Edge indices whose head is ``entity``."""
        lo, hi = self.offsets[entity], self.offsets[entity + 1]
        return self.order[lo:hi]

    def khop_edges(self, seeds, hops: int, max_edges: int = 4096) -> np.ndarray:
        """Edge indices of the <=``hops``-hop out-neighborhood of seeds."""
        frontier = list(np.atleast_1d(seeds))
        seen_nodes = set(frontier)
        edges: list[int] = []
        for _ in range(hops):
            nxt = []
            for e in frontier:
                for ei in self.out_edges(int(e)):
                    if len(edges) >= max_edges:
                        return np.asarray(edges, np.int32)
                    edges.append(int(ei))
                    t = int(self.tails[ei])
                    if t not in seen_nodes:
                        seen_nodes.add(t)
                        nxt.append(t)
            frontier = nxt
            if not frontier:
                break
        return np.asarray(edges, np.int32)

    def distances_from(self, seed: int, max_hops: int = 4) -> dict[int, int]:
        """BFS hop distance from ``seed`` (for DDE features)."""
        dist = {int(seed): 0}
        frontier = [int(seed)]
        for h in range(1, max_hops + 1):
            nxt = []
            for e in frontier:
                for ei in self.out_edges(e):
                    t = int(self.tails[ei])
                    if t not in dist:
                        dist[t] = h
                        nxt.append(t)
            frontier = nxt
            if not frontier:
                break
        return dist
