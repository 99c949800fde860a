"""Synthetic Freebase-like KGQA benchmark (CWQ / WebQSP analogues).

No Freebase dump ships in this container, so the paper's experimental
setting is reconstructed generatively (DESIGN §7.2):

* KG: power-law out-degree (Freebase-like), latent entity/relation
  embeddings with compositional structure — tail ~ head + relation + noise
  so a trained scorer can actually learn relevance.
* Queries: a random reasoning chain of ``hops`` relations from a topic
  entity; the query embedding is the composed chain signature + noise.
  Hop mix follows the paper's Table 2 (WebQSP: 65.5/34.5/0; CWQ:
  40.9/38.3/20.8 split over 1/2/>=3 hops).
* Ground truth per query: the gold chain edges (positives for scorer
  training), the answer entity, and the hop count (the paper's difficulty
  notion, §3.2).

The emergent phenomenon the paper relies on — 1-hop queries give the
scorer one dominant triple (high skew), multi-hop queries spread scores
over the chain and its neighborhood (low skew) — arises here from the
chain structure rather than being injected by hand.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.retrieval.kg import KnowledgeGraph

HOP_MIX = {
    "webqsp": {1: 0.655, 2: 0.345},
    "cwq": {1: 0.409, 2: 0.383, 3: 0.147, 4: 0.061},
}


@dataclasses.dataclass
class SyntheticKGQA:
    kg: KnowledgeGraph
    entity_emb: np.ndarray     # [n_entities, d]
    relation_emb: np.ndarray   # [n_relations, d]
    queries: list              # list[Query]


@dataclasses.dataclass
class Query:
    topic: int
    query_emb: np.ndarray
    gold_edges: np.ndarray     # edge ids of the reasoning chain
    answer: int
    hops: int


def make_kg(n_entities: int = 20_000, n_relations: int = 200,
            avg_degree: float = 8.0, d_emb: int = 32,
            seed: int = 0) -> tuple[KnowledgeGraph, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ent = rng.normal(0, 1, (n_entities, d_emb)).astype(np.float32)
    rel = rng.normal(0, 1, (n_relations, d_emb)).astype(np.float32)
    # power-law out-degree (Zipf-ish, clipped)
    deg = np.minimum(rng.zipf(1.7, n_entities), 200)
    deg = np.maximum((deg * avg_degree / deg.mean()).astype(np.int64), 1)
    n_edges = int(deg.sum())
    heads = np.repeat(np.arange(n_entities, dtype=np.int32), deg)
    rels = rng.integers(0, n_relations, n_edges).astype(np.int32)
    # compositional tails: nearest entity to head_emb + rel_emb (+ noise),
    # searched within a random candidate pool (exact NN over 20k x many
    # edges is needless — the pool keeps structure while staying O(E * P)).
    pool = rng.integers(0, n_entities, (n_edges, 16))
    target = ent[heads] + rel[rels] + rng.normal(0, 0.3, (n_edges, d_emb))
    dists = np.linalg.norm(ent[pool] - target[:, None, :], axis=-1)
    tails = pool[np.arange(n_edges), dists.argmin(1)].astype(np.int32)
    kg = KnowledgeGraph.build(heads, rels, tails, n_entities, n_relations)
    return kg, ent, rel


def make_queries(kg: KnowledgeGraph, ent: np.ndarray, rel: np.ndarray,
                 n_queries: int, dataset: str = "cwq",
                 query_noise: float = 0.25, seed: int = 1) -> list[Query]:
    rng = np.random.default_rng(seed)
    mix = HOP_MIX[dataset]
    hop_choices = np.asarray(list(mix.keys()))
    hop_probs = np.asarray(list(mix.values()))
    hop_probs = hop_probs / hop_probs.sum()
    queries: list[Query] = []
    attempts = 0
    while len(queries) < n_queries and attempts < n_queries * 20:
        attempts += 1
        hops = int(rng.choice(hop_choices, p=hop_probs))
        topic = int(rng.integers(0, kg.n_entities))
        node, chain = topic, []
        ok = True
        for _ in range(hops):
            edges = kg.out_edges(node)
            if len(edges) == 0:
                ok = False
                break
            ei = int(edges[rng.integers(0, len(edges))])
            chain.append(ei)
            node = int(kg.tails[ei])
        if not ok:
            continue
        # query signature: topic + sum of chain relations (what a language
        # encoder would extract from the natural-language question)
        sig = ent[topic] + rel[kg.rels[chain]].sum(0)
        q_emb = (sig + rng.normal(0, query_noise, sig.shape)).astype(np.float32)
        queries.append(Query(topic=topic, query_emb=q_emb,
                             gold_edges=np.asarray(chain, np.int32),
                             answer=node, hops=hops))
    return queries


def make_dataset(dataset: str = "cwq", n_queries: int = 800,
                 n_entities: int = 20_000, seed: int = 0) -> SyntheticKGQA:
    kg, ent, rel = make_kg(n_entities=n_entities, seed=seed)
    queries = make_queries(kg, ent, rel, n_queries, dataset=dataset,
                           seed=seed + 1)
    return SyntheticKGQA(kg=kg, entity_emb=ent, relation_emb=rel,
                         queries=queries)


def candidate_edges(kg: KnowledgeGraph, q: Query, max_edges: int = 512,
                    seed: int = 0) -> np.ndarray:
    """Retrieval candidate pool: the topic's k-hop neighborhood + the gold
    chain + random negatives (SubgraphRAG scores such a pool per query)."""
    rng = np.random.default_rng(seed + q.topic)
    local = kg.khop_edges(q.topic, hops=max(q.hops, 2), max_edges=max_edges // 2)
    n_rand = max_edges - len(local) - len(q.gold_edges)
    randoms = rng.integers(0, kg.n_triples, max(n_rand, 0)).astype(np.int32)
    pool = np.unique(np.concatenate([q.gold_edges, local, randoms]))
    rng.shuffle(pool)
    return pool[:max_edges]
