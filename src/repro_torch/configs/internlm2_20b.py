"""internlm2-20b: 48L, d_model 6144, 48 heads (GQA kv=8), d_ff 16384,
vocab 92544 [arXiv:2403.17297; hf]. Large-LM serving tier in SkewRoute."""

import torch

from repro_torch.models.layers import LMConfig

CONFIG = LMConfig(
    name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48,
    n_kv_heads=8, head_dim=128, d_ff=16384, vocab=92544,
    activation="swiglu", rope_theta=1_000_000.0, tie_embeddings=False,
    dtype=torch.bfloat16)
