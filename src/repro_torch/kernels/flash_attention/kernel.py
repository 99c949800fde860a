"""Causal GQA prefill attention — every prefill layer of every LLM tier.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention``, body ``_flash_kernel``). The CUDA source is
``repro_torch/kernels/csrc/flash_attention.cu``: one block per (batch,
head, 64 query rows) walking 64-key tiles through shared memory up to the
diagonal, with an fp32 online softmax (bound by operations; see the
source for the design). bf16 runs on the tensor cores (``mma.sync``,
fp32 accumulation, P split into two bf16 halves for P·V); fp32 on the
CUDA cores.

It takes the model's own layout — q ``[B, S, H, Dh]``, k/v ``[B, S, KV,
Dh]``, any strides with a contiguous last dimension and 16-byte aligned
rows — and any S (ragged tiles are masked in the kernel, no padding or
copy here). Dh is one of 16, 32, 64, 128.

:func:`flash_attention` launches the kernel for CUDA tensors, or raises;
only CPU tensors take :func:`flash_attention_plain`, the plain PyTorch
version (``ref.attention_ref`` on the same views).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, in the model's layout."""
    return ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q [B, S, H, Dh], k/v [B, S, KV, Dh] -> [B, S, H, Dh]; causal.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    dev = q.device
    if dev.type != "cuda" or q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention takes [B, S, H, Dh] CPU or CUDA "
                         f"tensors, got q {tuple(q.shape)} on {dev}")
    b, s, h, dh = q.shape
    kv = k.shape[2]
    if q.dtype not in DTYPES or dh not in HEAD_DIMS or kv < 1 or h % kv:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} (takes "
                         f"{DTYPES}), Dh {dh} (takes {HEAD_DIMS}), H {h} "
                         f"and KV {kv} (H % KV must be 0)")
    cuda_build.check_tensor(q, "q", (b, s, h, dh), q.dtype, dev,
                            strided=True)
    cuda_build.check_tensor(k, "k", (b, s, kv, dh), q.dtype, dev,
                            strided=True)
    cuda_build.check_tensor(v, "v", (b, s, kv, dh), q.dtype, dev,
                            strided=True)
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=dev)
    if b == 0 or s == 0:
        return out
    cuda_build.launch(
        "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, h, kv, dh, int(q.dtype == torch.bfloat16),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], dh ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.LAUNCHES["flash_attention"] += 1
    return out
