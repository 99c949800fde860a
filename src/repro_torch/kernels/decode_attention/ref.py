"""Plain PyTorch version of decode attention (the counterpart of the
reference's ``decode_ref``)."""

from __future__ import annotations

import torch


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: int) -> torch.Tensor:
    """q: [B, H, Dh]; k/v: [B, KV, S, Dh] -> [B, H, Dh]: the one new token
    of each sequence over cache positions < kv_len. fp32 math, output in
    q's dtype."""
    b, h, dh = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    kr = k.repeat_interleave(g, dim=1)
    vr = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kr.float()) * dh ** -0.5
    mask = torch.arange(s, device=q.device)[None, None, :] < kv_len
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vr.float()).to(q.dtype)
