"""LM serving engine: prefill + decode against a static KV cache.

One engine per tier (small / large model pool). Prompts right-pad to a
length bucket and decode greedily; the same
`repro_torch.models.transformer` code runs the toy test configs and the
full-width tiers — there is no separate "toy" model. Prefill runs the
CUDA flash-attention kernel once per layer, each decode step the CUDA
decode-attention kernel once per layer (CPU tensors take their plain
versions).

Kept from the reference (``repro/serving/engine.py``) as it behaves:
the first generated token comes from the prefill logits of the LAST
bucket position, a pad position whenever the prompt is shorter than its
bucket; decode starts at position ``s`` (the unpadded length) and
overwrites the pad slots of the re-homed cache; ``EngineBank`` zero-pads
the shorter prompts of a micro-batch to its longest, and those zeros are
attended as tokens.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import LMConfig
from repro_torch.serving.scheduler import bucket_size


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024)) -> int:
    return bucket_size(n, buckets)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, max_new]
    prompt_tokens: int
    generated_tokens: int


class LMEngine:
    """One tier's model: ``params`` as made by ``transformer.init_params``
    or ``params_from_jax``; it runs on the device its weights are on."""

    def __init__(self, cfg: LMConfig, params: dict, max_len: int = 2048):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def generate(self, prompts: np.ndarray, max_new: int = 16,
                 eos_id: Optional[int] = None) -> GenerationResult:
        """prompts: [B, S] int32 (right-padded with 0s is fine for the
        synthetic vocab). Greedy decode ``max_new`` tokens."""
        cfg = self.cfg
        b, s = prompts.shape
        sb = _bucket(s)
        total = _bucket(min(sb + max_new, self.max_len))
        toks = np.zeros((b, sb), np.int32)
        toks[:, :s] = prompts
        logits, cache = tfm.prefill(
            self.params, torch.as_tensor(toks, device=self.device), cfg)
        # re-home the prefill cache into a longer decode cache
        shape = (cfg.n_layers, b, total, cfg.kv_dim)
        decode_cache = {}
        for name, c in cache.items():
            decode_cache[name] = torch.zeros(shape, dtype=c.dtype,
                                             device=c.device)
            decode_cache[name][:, :, :sb] = c
        cache = decode_cache
        out = np.zeros((b, max_new), np.int32)
        next_tok = torch.argmax(logits, dim=-1)
        for i in range(max_new):
            out[:, i] = next_tok.cpu().numpy()
            logits, cache = tfm.decode_step(self.params, cache,
                                            next_tok[:, None], s + i, cfg)
            next_tok = torch.argmax(logits, dim=-1)
            if eos_id is not None and bool(np.all(out[:, i] == eos_id)):
                out = out[:, : i + 1]
                break
        return GenerationResult(tokens=out, prompt_tokens=b * s,
                                generated_tokens=out.size)


def make_engine(cfg: LMConfig, seed: int = 0, max_len: int = 2048,
                device: DeviceLike = None) -> LMEngine:
    """An engine with random weights drawn from a generator seeded with
    ``seed`` on ``device`` (default: CUDA), so a full-width tier is
    initialised on the card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LMEngine(cfg, tfm.init_params(gen, cfg), max_len=max_len)


class EngineBank:
    """Tier id -> LMEngine, adapted to micro-batch execution.

    The serving pipeline hands over lists of prompt arrays (one micro-
    batch from ``MicroBatchQueue``); the bank right-pads them to a common
    length and runs the tier's engine once. ``runners()`` exports the
    per-tier callables the pipeline consumes — tests inject fakes with
    the same signature.
    """

    def __init__(self, engines: dict[int, LMEngine], max_new: int = 16):
        if not engines:
            raise ValueError("EngineBank needs at least one tier engine")
        self.engines = dict(engines)
        self.max_new = max_new

    def run_tier(self, tier: int, prompts: list[np.ndarray]
                 ) -> GenerationResult:
        longest = max(p.shape[-1] for p in prompts)
        batch = np.zeros((len(prompts), longest), np.int32)
        for i, p in enumerate(prompts):
            batch[i, :p.shape[-1]] = p
        return self.engines[tier].generate(batch, max_new=self.max_new)

    def runners(self) -> dict[int, "functools.partial"]:
        return {t: functools.partial(self.run_tier, t) for t in self.engines}
