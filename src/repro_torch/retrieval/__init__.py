"""KG retrieval substrate: triple store, SubgraphRAG-style scorer,
neighbor sampler, and the synthetic Freebase-like KGQA benchmark."""
