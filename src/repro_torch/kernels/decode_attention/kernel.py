"""Decode attention — every decode layer of every LLM tier: one new token
per sequence against the KV cache.

Replaces the TPU kernel ``src/repro/kernels/decode_attention/kernel.py``
(``decode_attention``, body ``_decode_kernel``). The CUDA source is
``repro_torch/kernels/csrc/decode_attention.cu``: one block per (batch,
kv head) walking 128-position cache tiles up to ``kv_len``, the G query
heads of the kv head sharing each tile; online softmax and P·V in fp32
(bound by bytes; see the source for the design).

It takes the model's own layout — q ``[B, H, Dh]``, k/v ``[B, S, KV,
Dh]`` (the engine's flat ``[B, S, KV*Dh]`` cache of one layer, viewed per
head) with any strides, a contiguous last dimension and 16-byte aligned
rows — any S, and ``kv_len`` in [1, S] as a Python int. Dh is one of 16,
32, 64, 128; H / KV at most 16.

:func:`decode_attention` launches the kernel for CUDA tensors, or
raises; only CPU tensors take :func:`decode_attention_plain`, the plain
PyTorch version (``ref.decode_ref`` on the same views).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.decode_attention import ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: int) -> torch.Tensor:
    """The same function in plain PyTorch, in the model's layout."""
    return ref.decode_ref(q, k.transpose(1, 2), v.transpose(1, 2), kv_len)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: int) -> torch.Tensor:
    """q [B, H, Dh], k/v [B, S, KV, Dh], 1 <= kv_len <= S -> [B, H, Dh].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream or raises."""
    kv_len = int(kv_len)
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[1]}]")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    dev = q.device
    if dev.type != "cuda" or q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attention takes q [B, H, Dh] and k/v "
                         f"[B, S, KV, Dh] CPU or CUDA tensors, got q "
                         f"{tuple(q.shape)} on {dev}")
    b, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    if (q.dtype not in DTYPES or dh not in HEAD_DIMS or kv < 1 or h % kv
            or h // kv > MAX_GROUP):
        raise ValueError(f"decode_attention kernel: dtype {q.dtype} (takes "
                         f"{DTYPES}), Dh {dh} (takes {HEAD_DIMS}), H {h} "
                         f"and KV {kv} (H % KV == 0, H / KV <= {MAX_GROUP})")
    cuda_build.check_tensor(q, "q", (b, h, dh), q.dtype, dev,
                            strided=True)
    cuda_build.check_tensor(k, "k", (b, s, kv, dh), q.dtype, dev,
                            strided=True)
    cuda_build.check_tensor(v, "v", (b, s, kv, dh), q.dtype, dev,
                            strided=True)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=dev)
    if b == 0:
        return out
    cuda_build.launch(
        "decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, h, kv, dh, int(q.dtype == torch.bfloat16),
        kv_len, *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
        dh ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.LAUNCHES["decode_attention"] += 1
    return out
