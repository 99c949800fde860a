"""Public wrapper with the reference's signature: q [B, H, S, Dh], k/v
[B, KV, S, Dh] -> [B, H, S, Dh], causal, Sq == Sk.

It hands the kernel transposed views (no copy): the kernel reads any
strides. Runs where its inputs live: the CUDA kernel for CUDA tensors,
the plain PyTorch version for CPU tensors. Unlike the Pallas kernel it
takes any S; its tiles are fixed, so there are no block arguments.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """[B,H,S,Dh] x [B,KV,S,Dh]^2 -> [B,H,S,Dh] (causal, Sq == Sk)."""
    if q.shape[2] != k.shape[2]:
        raise NotImplementedError("prefill kernel expects Sq == Sk; decode "
                                  "uses repro_torch.kernels.decode_attention")
    return kernel.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2)).transpose(1, 2)


attention_ref = ref.attention_ref
