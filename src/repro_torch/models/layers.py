"""Shared transformer building blocks: norms, RoPE, GQA attention and GLU
MLPs, as plain functions on tensors with parameters in nested dicts (the
reference's layout, so weights carry across one to one).

Numerics follow ``repro/models/layers.py``: RMSNorm keeps its scale as a
delta from 1 and computes in float32; RoPE rotates split halves (not
interleaved pairs) with float32 angles; GeGLU uses the tanh-approximate
GELU; attention takes its dots in float32 from the inputs' dtype.

Initialisers draw from an explicit ``torch.Generator`` and place each
tensor on that generator's device, so a CUDA generator initialises a
full-width model on the card without a host round trip. The random
numbers differ from ``jax.random``'s; weights made by the reference come
across with :func:`repro_torch.models.transformer.params_from_jax`.

The routed-expert MLP (``moe_mlp``: llama4-scout, arctic) is a later
slice of the port (ROADMAP, queue 1, item "MoE tiers").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    capacity_factor: float = 1.25
    shared_expert: bool = False  # dense residual branch (Arctic / Llama-4)
    group_size: int = 512        # GShard dispatch group (tokens per group)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    activation: str = "swiglu"  # swiglu | geglu
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    scale_embed: bool = False   # gemma-style sqrt(d_model) embedding scale
    dtype: torch.dtype = torch.bfloat16
    # Serving-time knobs: None = auto (the CUDA kernels), "full" = the
    # plain masked-softmax path (`repro_torch.models.transformer.attention`)
    attn_impl: Optional[str] = None
    decode_attn_impl: Optional[str] = None

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_params(self) -> int:
        """Total parameter count."""
        c = self
        emb = c.vocab * c.d_model
        attn = c.d_model * (c.qkv_dim + 2 * c.kv_dim) + c.qkv_dim * c.d_model
        if c.moe is None:
            mlp = 3 * c.d_model * c.d_ff
        else:
            mlp = c.moe.n_experts * 3 * c.d_model * c.moe.d_ff
            mlp += c.d_model * c.moe.n_experts  # router
            if c.moe.shared_expert:
                mlp += 3 * c.d_model * c.d_ff
        norms = 2 * c.d_model
        per_layer = attn + mlp + norms
        head = 0 if c.tie_embeddings else c.d_model * c.vocab
        return emb + c.n_layers * per_layer + c.d_model + head


def init_normal(gen: torch.Generator, shape: tuple, std: float,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, std^2) drawn in float32 on the generator's device, then cast
    (the reference's ``(normal(key, shape) * std).astype(dtype)``)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


def init_rms_norm(d: int, dtype: torch.dtype = torch.bfloat16,
                  device=None) -> torch.Tensor:
    # Stored as delta from 1.0 (gemma convention); rms_norm adds 1.
    return torch.zeros((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2] (fp32)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, S, N, Dh]; positions: [B, S] or [S]."""
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * inv_freq       # [B,S,Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: LMConfig) -> dict:
    d, qd, kvd = cfg.d_model, cfg.qkv_dim, cfg.kv_dim
    s = d ** -0.5
    return {
        "wq": init_normal(gen, (d, qd), s, cfg.dtype),
        "wk": init_normal(gen, (d, kvd), s, cfg.dtype),
        "wv": init_normal(gen, (d, kvd), s, cfg.dtype),
        "wo": init_normal(gen, (qd, d), qd ** -0.5, cfg.dtype),
    }


def gqa_attention(q: torch.Tensor,            # [B, Sq, H, Dh]
                  k: torch.Tensor,            # [B, Sk, KV, Dh]
                  v: torch.Tensor,            # [B, Sk, KV, Dh]
                  mask: Optional[torch.Tensor],  # bool, -> [B, H, Sq, Sk]
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain grouped-query attention. Returns [B, Sq, H, Dh].

    Dots in float32 from the inputs' dtype; the probabilities are cast to
    ``v``'s dtype before P·V, as the reference's einsum path does. The
    CUDA kernels (``repro_torch.kernels.flash_attention`` /
    ``decode_attention``) replace this on the serving path; this is the
    ``attn_impl="full"`` path and the oracle.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    groups = h // kv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, sq, kv, groups, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if mask is not None:
        mask_ = mask.expand(b, h, sq, sk) if mask.dim() == 4 else mask
        mask_ = mask_.reshape(b, kv, groups, sq, sk)
        logits = torch.where(mask_, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    return out.reshape(b, sq, h, dh)


def causal_mask(sq: int, sk: int, offset: int = 0,
                device=None) -> torch.Tensor:
    """[1, 1, Sq, Sk] boolean causal mask; query i attends to keys <= i+offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    return (ki <= qi)[None, None]


# ---------------------------------------------------------------------------
# Dense GLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: LMConfig,
             d_ff: Optional[int] = None) -> dict:
    d_ff = cfg.d_ff if d_ff is None else d_ff
    d = cfg.d_model
    return {
        "w_gate": init_normal(gen, (d, d_ff), d ** -0.5, cfg.dtype),
        "w_up": init_normal(gen, (d, d_ff), d ** -0.5, cfg.dtype),
        "w_down": init_normal(gen, (d_ff, d), d_ff ** -0.5, cfg.dtype),
    }


def glu_mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if activation == "swiglu":
        act = F.silu(gate)
    elif activation == "geglu":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return (act * up) @ params["w_down"]


def _moe_not_ported(cfg: LMConfig) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: the routed-expert MLP is not ported yet (ROADMAP, "
        "queue 1, item 'MoE tiers': llama4-scout, arctic)")


def init_moe(gen: torch.Generator, cfg: LMConfig) -> dict:
    raise _moe_not_ported(cfg)


def moe_mlp(params: dict, x: torch.Tensor, cfg: LMConfig):
    raise _moe_not_ported(cfg)

