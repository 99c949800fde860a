"""Decode attention — every decode layer of every LLM tier: one new token
per sequence against the KV cache.

Replaces the TPU kernel ``src/repro/kernels/decode_attention/kernel.py``
(``decode_attention``, body ``_decode_kernel``). The CUDA source is
``repro_torch/kernels/csrc/decode_attention.cu``: split-KV — the cache up
to ``kv_len`` is cut into chunks of whole 128-position tiles
(:func:`split_plan`), one block per (chunk, kv head, batch) with the G
query heads of the kv head sharing each tile, each writing an fp32
partial; a second small kernel combines the partials. Online softmax and
P·V in fp32 (bound by bytes; see the source for the design). One call of
:func:`decode_attention` is one launch of the C launcher and counts once,
whether it runs one kernel (one chunk) or two.

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

import functools

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.decode_attention import ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16
TILE = 128            # cache positions per tile (kBK in the source)
BLOCKS_PER_SM = 2     # the split count aims at this many blocks per SM
MAX_SPLITS = 1024     # chunks the combine kernel takes (kMaxSplits)


def split_plan(b: int, kv: int, kv_len: int,
               n_sm: int = 132) -> tuple[int, int]:
    """(chunks, tiles per chunk) for a decode over ``kv_len`` positions.

    The fewest tiles per chunk is one; beyond that, chunks as large as
    still give ``b * kv * chunks >= BLOCKS_PER_SM * n_sm`` blocks, so
    every SM gets work and each block reads as much as it can. No chunk
    is empty, there are at most ``MAX_SPLITS``, and ``kv_len <= TILE``
    (or a batch that fills the card alone) gives one chunk."""
    n_tiles = -(-kv_len // TILE)
    want = -(-BLOCKS_PER_SM * n_sm // max(b * kv, 1))
    per = max(1, n_tiles // want, -(-n_tiles // MAX_SPLITS))
    return -(-n_tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    splits, per = split_plan(b, kv, kv_len, _sm_count(dev.index or 0))
    part = (torch.empty(b * h * splits * (dh + 2), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    cuda_build.launch(
        "decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, s, h,
        kv, dh, int(q.dtype == torch.bfloat16), kv_len, splits, per,
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], dh ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.LAUNCHES["decode_attention"] += 1
    return out
