"""Public wrapper with the reference's signature: q [B, H, Dh], k/v
[B, KV, S, Dh], kv_len -> [B, H, Dh].

It hands the kernel transposed views of k and v (no copy): the kernel
reads any strides. Runs where its inputs live: the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors. The cache tile is
fixed, so there is no block argument; any S is taken.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel, ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len) -> torch.Tensor:
    return kernel.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                   int(kv_len))


decode_ref = ref.decode_ref
