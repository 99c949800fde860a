"""Public wrappers for the fused triple scorer.

Both run where their inputs live (the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors) after casting to contiguous
float32 — the kernel's own launcher takes nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.triple_score import kernel, ref


def _f32(*xs):
    return [torch.as_tensor(x).to(torch.float32).contiguous() for x in xs]


def triple_score(triple_feats, query_emb, w1_t, w1_q, b1, w2, b2):
    """Shared candidate set: [N,Dt] x [Q,Dq] -> [Q,N]."""
    return kernel.triple_score(*_f32(triple_feats, query_emb, w1_t, w1_q,
                                     b1, w2, b2))


def triple_score_batched(triple_feats, query_emb, w1_t, w1_q, b1, w2, b2):
    """Per-query candidate sets: [B,N,Dt] x [B,Dq] -> [B,N] (any N)."""
    return kernel.triple_score_batched(*_f32(triple_feats, query_emb, w1_t,
                                             w1_q, b1, w2, b2))


triple_score_ref = ref.triple_score_ref
triple_score_batched_ref = ref.triple_score_batched_ref
