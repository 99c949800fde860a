"""Decoder-only transformer LM (dense GQA) — the serving half: prefill and
one-token decode against a static KV cache.

Counterpart of ``repro/models/transformer.py``. A Python loop over a list
of per-layer parameter dicts takes the place of ``lax.scan`` over stacked
ones; the model runs on one card, so there are no sharding annotations.
The KV cache keeps the reference's flat layout ``{"k"/"v": [L, B, S,
KV*Dh]}``; :func:`decode_step` writes the new token's k/v into it IN
PLACE (the reference returns an updated copy), which saves a whole-cache
copy per step.

Attention: prefill runs the hand-written CUDA flash kernel
(:mod:`repro_torch.kernels.flash_attention`) and decode the CUDA decode
kernel (:mod:`repro_torch.kernels.decode_attention`) where the reference
runs XLA attention; both read the model's ``[B, S, heads, Dh]`` tensors
and the flat cache as strided views, without copies. CPU tensors take
the kernels' plain versions. ``cfg.attn_impl`` / ``cfg.decode_attn_impl``
= ``"full"`` selects the plain masked-softmax path instead, as in the
reference.

Reference behaviours kept on purpose: ``prefill`` returns the logits of
the LAST position of its input (``hidden[:, -1]``), which for a
right-padded prompt is a pad position; RMSNorm, RoPE and GLU numerics are
those of :mod:`repro_torch.models.layers`.

The training half (``train_loss``, ``chunked_ce_loss``, ``backbone`` with
remat, the flash custom VJP) waits for the training slice.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import layers as L
from repro_torch.models.layers import LMConfig

# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: LMConfig) -> dict:
    dev = gen.device
    p = {
        "ln_attn": L.init_rms_norm(cfg.d_model, cfg.dtype, dev),
        "ln_mlp": L.init_rms_norm(cfg.d_model, cfg.dtype, dev),
        "attn": L.init_attention(gen, cfg),
    }
    if cfg.moe is None:
        p["mlp"] = L.init_mlp(gen, cfg)
    else:
        p["moe"] = L.init_moe(gen, cfg)
    return p


def init_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    """Random weights drawn from ``gen``, on ``gen``'s device. Layers are
    a list of per-layer dicts (the reference stacks them on a leading L
    axis)."""
    params = {
        "embed": L.init_normal(gen, (cfg.vocab, cfg.d_model),
                           cfg.d_model ** -0.5, cfg.dtype),
        "layers": [init_layer(gen, cfg) for _ in range(cfg.n_layers)],
        "ln_final": L.init_rms_norm(cfg.d_model, cfg.dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_normal(gen, (cfg.d_model, cfg.vocab),
                                      cfg.d_model ** -0.5, cfg.dtype)
    return params


def _to_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array of any float dtype (bfloat16 arrays from JAX are
    ``ml_dtypes`` arrays, which ``torch.from_numpy`` rejects) -> tensor.
    Goes through float32, which holds every bfloat16 exactly."""
    arr = np.asarray(x).astype(np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def params_from_jax(params_np: Mapping, cfg: LMConfig,
                    device: DeviceLike = None) -> dict:
    """Carry weights made by the reference (``repro.models.transformer.
    init_params``, converted to numpy) across: the stacked ``[L, ...]``
    layer arrays are split into per-layer tensors of ``cfg.dtype`` on
    ``device`` (default: CUDA)."""
    dev = resolve_device(device)
    if cfg.moe is not None:
        L.init_moe(None, cfg)           # raises: not ported yet

    def conv(x):
        return _to_tensor(x, cfg.dtype, dev)

    stacked = params_np["layers"]
    layers = []
    for i in range(cfg.n_layers):
        layers.append({
            "ln_attn": conv(stacked["ln_attn"][i]),
            "ln_mlp": conv(stacked["ln_mlp"][i]),
            "attn": {k: conv(stacked["attn"][k][i])
                     for k in ("wq", "wk", "wv", "wo")},
            "mlp": {k: conv(stacked["mlp"][k][i])
                    for k in ("w_gate", "w_up", "w_down")},
        })
    params = {"embed": conv(params_np["embed"]), "layers": layers,
              "ln_final": conv(params_np["ln_final"])}
    if not cfg.tie_embeddings:
        params["lm_head"] = conv(params_np["lm_head"])
    return params


# ---------------------------------------------------------------------------
# Attention paths
# ---------------------------------------------------------------------------


def _full_attention(q, k, v, *, causal_offset: int, kv_len: Optional[int]):
    sq, sk = q.shape[1], k.shape[1]
    mask = L.causal_mask(sq, sk, offset=causal_offset, device=q.device)
    if kv_len is not None:  # decode: only cache positions < kv_len are valid
        mask = mask & (torch.arange(sk, device=q.device) < kv_len)
    return L.gqa_attention(q, k, v, mask)


def attention(q, k, v, cfg: LMConfig, *, causal_offset: int = 0,
              kv_len: Optional[int] = None, impl: Optional[str] = None):
    """q [B, Sq, H, Dh], k/v [B, Sk, KV, Dh] -> [B, Sq, H, Dh].

    ``impl``: ``"flash"`` (causal prefill, Sq == Sk: the flash kernel),
    ``"decode"`` (Sq == 1 against a cache masked at ``kv_len``: the
    decode kernel) or ``"full"`` (plain masked softmax). ``None`` takes
    ``cfg.attn_impl``, and if that is None too, picks flash or decode
    from the shapes as the reference picks its paths."""
    sq, sk = q.shape[1], k.shape[1]
    if impl is None:
        impl = cfg.attn_impl
    if impl is None:
        if kv_len is None and sq == sk:
            impl = "flash"
        elif sq == 1 and kv_len is not None:
            impl = "decode"
        else:
            impl = "full"
    if impl == "flash":
        return flash_kernel.flash_attention(q, k, v)
    if impl == "decode":
        return decode_kernel.decode_attention(q[:, 0], k, v,
                                              kv_len)[:, None]
    if impl == "full":
        return _full_attention(q, k, v, causal_offset=causal_offset,
                               kv_len=kv_len)
    raise ValueError(f"unknown attention impl {impl!r} (flash | decode | "
                     f"full; the reference's 'chunked' computes what "
                     f"'full' does and is not ported)")


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------


def _qkv(p_attn: dict, x: torch.Tensor, cfg: LMConfig,
         positions: torch.Tensor):
    b, s, _ = x.shape
    q = (x @ p_attn["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p_attn["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p_attn["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp(p: dict, h: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    if cfg.moe is not None:
        return L.moe_mlp(p["moe"], h, cfg)
    return L.glu_mlp(p["mlp"], h, cfg.activation)


def decoder_layer_decode(p: dict, x: torch.Tensor, cfg: LMConfig,
                         cache_k: torch.Tensor, cache_v: torch.Tensor,
                         pos: int) -> torch.Tensor:
    """Single-token layer against a static-size KV cache.

    cache_k/v: [B, S, KV*Dh], one layer's slice of the cache, written at
    ``pos`` in place; pos: the current length (write index and mask
    bound ``kv_len = pos + 1``). Returns x."""
    b = x.shape[0]
    h = L.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p["attn"], h, cfg, positions)
    s = cache_k.shape[1]
    # the reference's dynamic_update_slice clamps its start index
    at = min(max(pos, 0), s - 1)
    cache_k[:, at] = k.reshape(b, cfg.kv_dim).to(cache_k.dtype)
    cache_v[:, at] = v.reshape(b, cfg.kv_dim).to(cache_v.dtype)
    k_all = cache_k.view(b, s, cfg.n_kv_heads, cfg.head_dim)
    v_all = cache_v.view(b, s, cfg.n_kv_heads, cfg.head_dim)
    attn_out = attention(q, k_all, v_all, cfg, causal_offset=pos,
                         kv_len=min(pos + 1, s), impl=cfg.decode_attn_impl)
    x = x + attn_out.reshape(b, 1, cfg.qkv_dim) @ p["attn"]["wo"]
    h = L.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return x + _mlp(p, h, cfg)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed(params: dict, tokens: torch.Tensor, cfg: LMConfig):
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return x


def _head_matrix(params: dict, cfg: LMConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig
            ) -> tuple[torch.Tensor, dict]:
    """Prompt processing: tokens [B, S] -> (last-position logits [B, V]
    fp32, cache {"k"/"v": [L, B, S, KV*Dh]})."""
    b, s = tokens.shape
    dev = params["embed"].device
    tokens = tokens.to(dev)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=dev)
    shape = (cfg.n_layers, b, s, cfg.kv_dim)
    cache = {"k": torch.empty(shape, dtype=cfg.dtype, device=dev),
             "v": torch.empty(shape, dtype=cfg.dtype, device=dev)}
    for i, p in enumerate(params["layers"]):
        h = L.rms_norm(x, p["ln_attn"], cfg.norm_eps)
        q, k, v = _qkv(p["attn"], h, cfg, positions)
        attn_out = attention(q, k, v, cfg).reshape(b, s, cfg.qkv_dim)
        x = x + attn_out @ p["attn"]["wo"]
        h = L.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        x = x + _mlp(p, h, cfg)
        cache["k"][i] = k.reshape(b, s, cfg.kv_dim)
        cache["v"][i] = v.reshape(b, s, cfg.kv_dim)
    hidden = L.rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = (hidden[:, -1, :] @ _head_matrix(params, cfg)).float()
    return logits, cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens [B, 1]; pos (int): the current length.

    Returns (logits [B, V] fp32, cache) — the same cache dict, updated in
    place. Cache: {"k"/"v": [L, B, S, KV*Dh]}."""
    pos = int(pos)
    x = _embed(params, tokens.to(params["embed"].device), cfg)
    for i, p in enumerate(params["layers"]):
        x = decoder_layer_decode(p, x, cfg, cache["k"][i], cache["v"][i],
                                 pos)
    hidden = L.rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = (hidden[:, 0, :] @ _head_matrix(params, cfg)).float()
    return logits, cache


def init_cache(cfg: LMConfig, batch: int, seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> dict:
    shape = (cfg.n_layers, batch, seq, cfg.kv_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
