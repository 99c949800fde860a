"""deepfm: 39 sparse fields, embed 10, deep MLP 400-400-400, FM
interaction [arXiv:1703.04247; paper]. 1M-bucket hashed vocab/field.
The small ranker (tier 0) of the recsys routing path."""

from repro_torch.models.recsys import RecsysConfig

SOURCE = "arXiv:1703.04247; paper"

CONFIG = RecsysConfig(
    name="deepfm", model="deepfm", n_dense=0, n_sparse=39, embed_dim=10,
    vocab_sizes=(1_000_000,) * 39, deep_mlp=(400, 400, 400),
    interaction="fm")
