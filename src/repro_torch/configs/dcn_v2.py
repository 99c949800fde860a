"""dcn-v2: 13 dense + 26 sparse, embed 16, 3 full-rank cross layers,
deep MLP 1024-1024-512, parallel structure [arXiv:2008.13535; paper].
Criteo-Kaggle vocabulary. The large ranker (tier 1) of the recsys
routing path."""

from repro_torch.models.recsys import CRITEO_KAGGLE_VOCABS, RecsysConfig

SOURCE = "arXiv:2008.13535; paper"

CONFIG = RecsysConfig(
    name="dcn-v2", model="dcn_v2", n_dense=13, n_sparse=26, embed_dim=16,
    vocab_sizes=CRITEO_KAGGLE_VOCABS, deep_mlp=(1024, 1024, 512),
    n_cross_layers=3, interaction="cross")
