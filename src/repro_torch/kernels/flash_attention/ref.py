"""Plain PyTorch version of the causal GQA prefill attention (the
counterpart of the reference's ``attention_ref``)."""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """q: [B, H, Sq, Dh]; k/v: [B, KV, Sk, Dh] -> [B, H, Sq, Dh]; causal,
    the queries being the last Sq positions. fp32 math, output in q's
    dtype. Materialises the [B, H, Sq, Sk] fp32 scores."""
    b, h, sq, dh = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * dh ** -0.5
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    mask = torch.arange(sk, device=q.device)[None, :] <= q_pos
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
