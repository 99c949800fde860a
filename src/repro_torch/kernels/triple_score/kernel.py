"""Fused SubgraphRAG triple-scorer kernel.

The retrieval hot path (paper §2: scorer R over candidate triples): every
candidate triple of a query gets a relevance score from a 2-layer MLP
over [triple_features ++ query_embedding]. Because the query part is
shared across all triples of a query, the first layer splits as

    h = relu(T @ W1_t  +  (q @ W1_q + b1))     score = h @ w2 + b2

Replaces the TPU kernels of ``src/repro/kernels/triple_score/kernel.py``:
``triple_score_batched`` (each query scores its own [N, Dt] candidate
rows) and ``triple_score`` (Q queries over one shared candidate set). One
CUDA kernel (``repro_torch/kernels/csrc/triple_score.cu``) serves both —
the shared variant is a feature batch stride of 0. The per-query bias
``q @ W1_q + b1`` is a small product computed here with ``torch.matmul``,
outside the kernel, as the reference computes it outside its Pallas call;
the kernel does ``T @ W1_t``, bias, relu and the ``w2`` product in fp32
FMA (no TF32), keeping the [N, H] hidden activations in registers. It is
bound by operations at the paper-scale width (Dt=1156, H=1024): a
register-blocked 128x128 SGEMM tile with a double-buffered shared-memory
ring. Unlike the Pallas kernel it needs no padding: any N works, ragged
tails are masked in the kernel.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
PyTorch version (:mod:`repro_torch.kernels.triple_score.ref`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.triple_score.ref import (triple_score_batched_ref,
                                                  triple_score_ref)

triple_score_plain = triple_score_ref
triple_score_batched_plain = triple_score_batched_ref


def _launch(counter: str, feats: torch.Tensor, feat_stride: int,
            query_emb, w1_t, w1_q, b1, w2, b2, queries: int, n: int,
            dt: int) -> torch.Tensor:
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"{counter} takes CPU or CUDA tensors, got {dev}")
    h = w1_t.shape[1] if w1_t.dim() == 2 else -1
    dq = query_emb.shape[1] if query_emb.dim() == 2 else -1
    f32 = torch.float32
    check = cuda_build.check_tensor
    check(query_emb, "query_emb", (queries, dq), f32, dev)
    check(w1_t, "w1_t", (dt, h), f32, dev)
    check(w1_q, "w1_q", (dq, h), f32, dev)
    check(b1, "b1", (h,), f32, dev)
    check(w2, "w2", (h, 1), f32, dev)
    check(b2, "b2", (1,), f32, dev)
    q_bias = query_emb @ w1_q + b1                          # [Q, H]
    out = torch.empty((queries, n), dtype=f32, device=dev)
    if queries == 0 or n == 0:
        return out
    cuda_build.launch(
        "triple_score", feats.data_ptr(), feat_stride, q_bias.data_ptr(),
        w1_t.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        queries, n, dt, h, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.LAUNCHES[counter] += 1
    return out


def triple_score_batched(triple_feats: torch.Tensor, query_emb, w1_t, w1_q,
                         b1, w2, b2) -> torch.Tensor:
    """Per-query candidate sets: [B, N, Dt] x [B, Dq] -> [B, N] scores."""
    if triple_feats.device.type == "cpu":
        return triple_score_batched_plain(triple_feats, query_emb, w1_t,
                                          w1_q, b1, w2, b2)
    if triple_feats.dim() != 3:
        raise ValueError(f"triple_feats must be [B, N, Dt], got "
                         f"{tuple(triple_feats.shape)}")
    b, n, dt = triple_feats.shape
    cuda_build.check_tensor(triple_feats, "triple_feats", (b, n, dt),
                            torch.float32, triple_feats.device)
    return _launch("triple_score_batched", triple_feats, n * dt, query_emb,
                   w1_t, w1_q, b1, w2, b2, b, n, dt)


def triple_score(triple_feats: torch.Tensor, query_emb, w1_t, w1_q, b1, w2,
                 b2) -> torch.Tensor:
    """One shared candidate set: [N, Dt] x [Q, Dq] -> [Q, N] scores."""
    if triple_feats.device.type == "cpu":
        return triple_score_plain(triple_feats, query_emb, w1_t, w1_q, b1,
                                  w2, b2)
    if triple_feats.dim() != 2:
        raise ValueError(f"triple_feats must be [N, Dt], got "
                         f"{tuple(triple_feats.shape)}")
    n, dt = triple_feats.shape
    cuda_build.check_tensor(triple_feats, "triple_feats", (n, dt),
                            torch.float32, triple_feats.device)
    return _launch("triple_score", triple_feats, 0, query_emb, w1_t, w1_q,
                   b1, w2, b2, query_emb.shape[0], n, dt)
