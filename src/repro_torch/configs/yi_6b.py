"""yi-6b: 32L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000
[arXiv:2403.04652; hf]. llama-arch GQA; small-LM serving tier."""

import torch

from repro_torch.models.layers import LMConfig

CONFIG = LMConfig(
    name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    head_dim=128, d_ff=11008, vocab=64000, activation="swiglu",
    rope_theta=5_000_000.0, tie_embeddings=False, dtype=torch.bfloat16)
