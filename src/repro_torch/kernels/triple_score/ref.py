"""Plain PyTorch oracle for the fused triple scorer."""

from __future__ import annotations

import torch


def triple_score_ref(triple_feats, query_emb, w1_t, w1_q, b1, w2, b2):
    """[N,Dt] x [Q,Dq] -> [Q,N] 2-layer-MLP relevance scores."""
    t32 = triple_feats.to(torch.float32)
    q32 = query_emb.to(torch.float32)
    h = (t32 @ w1_t.to(torch.float32))[None, :, :] \
        + (q32 @ w1_q.to(torch.float32) + b1)[:, None, :]
    h = torch.relu(h)
    return (h @ w2.to(torch.float32))[..., 0] + b2[0]


def triple_score_batched_ref(triple_feats, query_emb, w1_t, w1_q, b1, w2,
                             b2):
    """Per-query candidates: [B,N,Dt] x [B,Dq] -> [B,N] scores."""
    t32 = triple_feats.to(torch.float32)
    q32 = query_emb.to(torch.float32)
    h = t32 @ w1_t.to(torch.float32) \
        + (q32 @ w1_q.to(torch.float32) + b1)[:, None, :]
    h = torch.relu(h)
    return (h @ w2.to(torch.float32))[..., 0] + b2[0]
