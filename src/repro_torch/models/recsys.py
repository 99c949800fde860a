"""Recommendation/ranking models: DLRM, DCN-v2, DeepFM, DIEN — the serve
half of the reference's ``repro/models/recsys.py``.

The embedding layer is one concatenated ``[sum_vocab, dim]`` table with
per-field row offsets. Its reduces run through the port's hand-written
``segment_reduce`` kernel (``repro_torch.kernels.segment_reduce``): the
field mean of ``user_embedding`` (dcn_v2, deepfm) is one
``embedding_bag_fused`` launch that gathers and reduces in the kernel, and
DeepFM's three field sums (first-order weights, ``sum v`` and ``sum v^2``)
are one ``segment_sum_sorted`` launch over the concatenated
``[B*F, 1 + 2d]`` rows. The reference takes these with XLA reduces; they
compute the same function (its ``tests/test_kernels.py`` holds
``embedding_bag_fused`` against ``embedding_bag``).

Each model exposes, as in the reference:
  * ``init_params(gen, cfg, device)`` — from an explicit ``torch.Generator``
    (or an int seed) on an explicit device;
  * ``forward(params, cfg, batch) -> logits [B]`` (serve_p99 / serve_bulk);
  * ``retrieval_scores(params, cfg, batch, candidate_ids) -> [B, C]``:
    one user representation dotted against the gathered candidate rows,
    one ``torch.matmul``.

CUDA tensors launch the kernel; CPU tensors take its plain PyTorch
version. The training half (``loss``) is not ported yet. The reference's
sharding annotations are no-ops on one card and are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.kernels.device import DeviceLike, resolve_device
from repro_torch.kernels.segment_reduce import kernel as seg_kernel
from repro_torch.kernels.segment_reduce import ops as seg_ops

# ---------------------------------------------------------------------------
# Published vocab tables
# ---------------------------------------------------------------------------

#: Criteo Terabyte (MLPerf DLRM benchmark) per-table row counts.
CRITEO_TB_VOCABS: tuple[int, ...] = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)

#: Criteo Kaggle per-field vocab (DCN-v2 paper's dataset).
CRITEO_KAGGLE_VOCABS: tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572)

#: DIEN (Amazon Books): users / items / categories.
AMAZON_BOOKS_VOCABS = {"user": 543060, "item": 367983, "cat": 1601}


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                       # dlrm | dcn_v2 | deepfm | dien
    n_dense: int
    n_sparse: int
    embed_dim: int
    vocab_sizes: tuple[int, ...]
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    deep_mlp: tuple[int, ...] = ()
    n_cross_layers: int = 0
    interaction: str = "dot"         # dot | cross | fm | augru
    # DIEN only
    seq_len: int = 0
    gru_dim: int = 0
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def padded_vocab(self) -> int:
        """Row count padded to 512 (the reference's row-sharding rule, kept
        so tables and global ids match it)."""
        t = self.total_vocab
        return -(-t // 512) * 512

    @property
    def row_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int64)

    @property
    def n_embedding_params(self) -> int:
        return self.total_vocab * self.embed_dim


Generator = Union[torch.Generator, int]
Batch = Mapping[str, object]


def _generator(gen: Generator, dev: torch.device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, parameters on "
                             f"{dev}: pass a generator for the device")
        return gen
    return torch.Generator(device=dev).manual_seed(int(gen))


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            dev: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev).mul_(scale).to(dtype)


def _on(x, dev: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=dev, dtype=dtype)


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------


def init_tables(gen: Generator, cfg: RecsysConfig,
                device: DeviceLike = None) -> torch.Tensor:
    """One concatenated [padded_vocab, dim] table."""
    dev = resolve_device(device)
    return _normal(_generator(gen, dev), (cfg.padded_vocab, cfg.embed_dim),
                   cfg.embed_dim ** -0.5, cfg.param_dtype, dev)


def to_global_ids(cfg: RecsysConfig, field_ids) -> torch.Tensor:
    """field_ids [B, F] local ids -> [B, F] int64 rows of the table."""
    field_ids = torch.as_tensor(field_ids)
    offsets = torch.as_tensor(cfg.row_offsets[: field_ids.shape[1]],
                              device=field_ids.device)
    return field_ids.long() + offsets[None, :]


def embedding_lookup(tables: torch.Tensor, cfg: RecsysConfig,
                     field_ids) -> torch.Tensor:
    """Per-field lookup. field_ids: [B, F] local ids -> [B, F, dim]."""
    return tables[to_global_ids(cfg, _on(field_ids, tables.device))]


def _bag_segments(b: int, nnz: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(b, device=dev, dtype=torch.int32).repeat_interleave(
        nnz)


def embedding_bag(tables: torch.Tensor, global_ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  combiner: str = "sum") -> torch.Tensor:
    """Multi-hot bag: global_ids [B, nnz] (-1 = pad) -> [B, dim].

    == torch nn.EmbeddingBag(mode=combiner). Without ``weights`` one
    ``embedding_bag_fused`` launch gathers and reduces; with per-id
    ``weights`` the rows are gathered and weighted here and reduced by
    ``segment_sum_sorted``, and ``mean`` divides by the summed weights
    (at least 1), as the reference does."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    ids = _on(global_ids, tables.device)
    b, nnz = ids.shape
    if weights is None:
        return seg_ops.embedding_bag_fused(tables, ids, b, combiner)
    mask = ids >= 0
    rows = seg_kernel.take_rows(tables, ids)                     # [B,nnz,dim]
    w = mask.to(rows.dtype) * _on(weights, tables.device, rows.dtype)
    summed = seg_ops.segment_sum_sorted(
        (rows * w[..., None]).reshape(b * nnz, -1),
        _bag_segments(b, nnz, tables.device), b, nnz)
    if combiner == "sum":
        return summed
    return summed / w.sum(1, keepdim=True).clamp(min=1.0)


# ---------------------------------------------------------------------------
# MLP helper
# ---------------------------------------------------------------------------


def init_mlp_stack(gen: Generator, dims: Sequence[int], dtype,
                   prefix: str = "mlp", device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    g = _generator(gen, dev)
    out = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{prefix}{i}"] = {
            "w": _normal(g, (d_in, d_out), (2.0 / d_in) ** 0.5, dtype, dev),
            "b": torch.zeros((d_out,), dtype=dtype, device=dev),
        }
    return out


def mlp_apply(params: dict, x: torch.Tensor, n_layers: int,
              prefix: str = "mlp", final_relu: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        p = params[f"{prefix}{i}"]
        x = x @ p["w"] + p["b"]
        if i < n_layers - 1 or final_relu:
            x = torch.relu(x)
    return x


def _bce(logits, labels):
    raise NotImplementedError(
        "recsys training (loss / _bce) is not ported yet: ROADMAP queue 1 "
        "item 9")


# ---------------------------------------------------------------------------
# DLRM (Naumov et al. 2019, MLPerf config)
# ---------------------------------------------------------------------------


def init_dlrm(gen: Generator, cfg: RecsysConfig,
              device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    g = _generator(gen, dev)
    n_emb = cfg.n_sparse + 1  # +1 for the bottom-MLP dense embedding
    n_interactions = n_emb * (n_emb - 1) // 2
    top_in = cfg.embed_dim + n_interactions
    return {
        "tables": init_tables(g, cfg, dev),
        "bot": init_mlp_stack(g, (cfg.n_dense,) + cfg.bot_mlp, cfg.dtype,
                              "bot", dev),
        "top": init_mlp_stack(g, (top_in,) + cfg.top_mlp, cfg.dtype, "top",
                              dev),
    }


def dlrm_forward(params: dict, cfg: RecsysConfig,
                 batch: Batch) -> torch.Tensor:
    dev = params["tables"].device
    dense = _on(batch["dense"], dev).to(cfg.dtype)                # [B, 13]
    dense_emb = mlp_apply(params["bot"], dense, len(cfg.bot_mlp), "bot",
                          final_relu=True)                        # [B, 128]
    sparse = embedding_lookup(params["tables"], cfg, batch["sparse"])
    z = torch.cat([dense_emb[:, None, :], sparse.to(cfg.dtype)], 1)
    # Pairwise dot interaction (upper triangle, no self terms).
    zz = torch.einsum("bnd,bmd->bnm", z, z)
    n = z.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=dev)
    inter = zz[:, iu, ju]                                         # [B, n(n-1)/2]
    top_in = torch.cat([dense_emb, inter], 1)
    return mlp_apply(params["top"], top_in, len(cfg.top_mlp), "top")[:, 0]


# ---------------------------------------------------------------------------
# DCN-v2 (Wang et al. 2021) — full-rank cross layers, parallel deep tower
# ---------------------------------------------------------------------------


def init_dcn(gen: Generator, cfg: RecsysConfig,
             device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    g = _generator(gen, dev)
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    cross = {}
    for i in range(cfg.n_cross_layers):
        cross[f"cross{i}"] = {
            "w": _normal(g, (d0, d0), d0 ** -0.5, cfg.dtype, dev),
            "b": torch.zeros((d0,), dtype=cfg.dtype, device=dev),
        }
    return {
        "tables": init_tables(g, cfg, dev),
        "cross": cross,
        "deep": init_mlp_stack(g, (d0,) + cfg.deep_mlp, cfg.dtype, "deep",
                               dev),
        "final": init_mlp_stack(g, (d0 + cfg.deep_mlp[-1], 1), cfg.dtype,
                                "final", dev),
    }


def dcn_forward(params: dict, cfg: RecsysConfig, batch: Batch) -> torch.Tensor:
    dev = params["tables"].device
    emb = embedding_lookup(params["tables"], cfg, batch["sparse"])
    x0 = torch.cat([_on(batch["dense"], dev).to(cfg.dtype),
                    emb.reshape(emb.shape[0], -1).to(cfg.dtype)], 1)
    x = x0
    for i in range(cfg.n_cross_layers):
        p = params["cross"][f"cross{i}"]
        x = x0 * (x @ p["w"] + p["b"]) + x                        # DCN-v2 cross
    deep = mlp_apply(params["deep"], x0, len(cfg.deep_mlp), "deep",
                     final_relu=True)
    out = torch.cat([x, deep], 1)
    return mlp_apply(params["final"], out, 1, "final")[:, 0]


# ---------------------------------------------------------------------------
# DeepFM (Guo et al. 2017)
# ---------------------------------------------------------------------------


def init_deepfm(gen: Generator, cfg: RecsysConfig,
                device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    g = _generator(gen, dev)
    d_in = cfg.n_sparse * cfg.embed_dim
    return {
        "tables": init_tables(g, cfg, dev),
        "fm": {"w1": _normal(g, (cfg.padded_vocab, 1), 0.01,
                             cfg.param_dtype, dev)},  # first-order weights
        "deep": init_mlp_stack(g, (d_in,) + cfg.deep_mlp + (1,), cfg.dtype,
                               "deep", dev),
    }


def deepfm_forward(params: dict, cfg: RecsysConfig,
                   batch: Batch) -> torch.Tensor:
    """First order + FM second order + deep tower. The three sums over
    the F fields are one ``segment_sum_sorted`` launch over the rows
    ``[first, v, v*v]`` of every (request, field)."""
    dev = params["tables"].device
    gids = to_global_ids(cfg, _on(batch["sparse"], dev))
    b, f = gids.shape
    d = cfg.embed_dim
    emb = params["tables"][gids].to(cfg.dtype)                    # [B,F,d]
    first = params["fm"]["w1"][gids].to(cfg.dtype)                # [B,F,1]
    rows = torch.cat([first, emb, emb * emb], -1).reshape(b * f, 1 + 2 * d)
    sums = seg_ops.segment_sum_sorted(rows, _bag_segments(b, f, dev), b, f)
    fm1, sum_v, sum_v2 = sums[:, 0], sums[:, 1:1 + d], sums[:, 1 + d:]
    # Second order: 1/2 ((sum v)^2 - sum v^2), summed over embed dim.
    fm2 = 0.5 * torch.sum(sum_v * sum_v - sum_v2, 1)
    deep = mlp_apply(params["deep"], emb.reshape(b, -1),
                     len(cfg.deep_mlp) + 1, "deep")[:, 0]
    return fm1 + fm2 + deep


# ---------------------------------------------------------------------------
# DIEN (Zhou et al. 2019) — GRU interest extraction + AUGRU evolution
# ---------------------------------------------------------------------------


def _init_gru(g: torch.Generator, d_in: int, d_h: int, dtype,
              dev: torch.device) -> dict:
    return {
        "wx": _normal(g, (d_in, 3 * d_h), (1.0 / d_in) ** 0.5, dtype, dev),
        "wh": _normal(g, (d_h, 3 * d_h), (1.0 / d_h) ** 0.5, dtype, dev),
        "b": torch.zeros((3 * d_h,), dtype=dtype, device=dev),
    }


def _gru_cell(p: dict, h: torch.Tensor, x: torch.Tensor,
              att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GRU step; with ``att`` it's AUGRU (attention scales the update gate)."""
    gx = x @ p["wx"] + p["b"]
    gh = h @ p["wh"]
    rx, ux, cx = torch.chunk(gx, 3, -1)
    rh, uh, ch = torch.chunk(gh, 3, -1)
    r = torch.sigmoid(rx + rh)
    u = torch.sigmoid(ux + uh)
    c = torch.tanh(cx + r * ch)  # reset gate scales the hidden contribution
    if att is not None:
        u = u * att[:, None]
    return (1.0 - u) * h + u * c


def init_dien(gen: Generator, cfg: RecsysConfig,
              device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    g = _generator(gen, dev)
    d_item = 2 * cfg.embed_dim  # item + category embedding concat
    mlp_in = cfg.gru_dim + d_item + cfg.embed_dim  # interest + target + user
    return {
        "tables": init_tables(g, cfg, dev),
        "gru": _init_gru(g, d_item, cfg.gru_dim, cfg.dtype, dev),
        "augru": _init_gru(g, cfg.gru_dim, cfg.gru_dim, cfg.dtype, dev),
        "att": {"w": _normal(g, (cfg.gru_dim, d_item), cfg.gru_dim ** -0.5,
                             cfg.dtype, dev)},
        "deep": init_mlp_stack(g, (mlp_in,) + cfg.deep_mlp + (1,), cfg.dtype,
                               "deep", dev),
        "proj": {"w": _normal(g, (cfg.gru_dim, d_item), cfg.gru_dim ** -0.5,
                              cfg.dtype, dev)},
    }


def _dien_embed(params: dict, cfg: RecsysConfig, batch: Batch):
    """DIEN fields: user_id | target (item, cat) | history [S] (item, cat)."""
    offsets = cfg.row_offsets
    user_off, item_off, cat_off = 0, int(offsets[1]), int(offsets[2])
    tables = params["tables"]
    dev = tables.device

    def take(key, off):
        return tables[_on(batch[key], dev).long() + off]

    user = take("user_id", user_off)
    t_item, t_cat = take("target_item", item_off), take("target_cat", cat_off)
    h_item, h_cat = take("hist_items", item_off), take("hist_cats", cat_off)
    target = torch.cat([t_item, t_cat], -1).to(cfg.dtype)         # [B, 2d]
    hist = torch.cat([h_item, h_cat], -1).to(cfg.dtype)           # [B, S, 2d]
    return user.to(cfg.dtype), target, hist


def dien_interest(params: dict, cfg: RecsysConfig, target: torch.Tensor,
                  hist: torch.Tensor, hist_mask) -> torch.Tensor:
    """GRU over history -> attention vs target -> AUGRU. Returns [B, gru_dim].
    The reference's two ``lax.scan``s are loops over ``seq_len``."""
    b = hist.shape[0]
    h0 = torch.zeros((b, cfg.gru_dim), dtype=cfg.dtype, device=hist.device)
    xs = hist.transpose(0, 1)                                     # [S, B, 2d]
    ms = _on(hist_mask, hist.device).to(cfg.dtype).T              # [S, B]

    h, states = h0, []
    for x, m in zip(xs, ms):
        h_new = _gru_cell(params["gru"], h, x)
        h = m[:, None] * h_new + (1 - m[:, None]) * h
        states.append(h)
    states = torch.stack(states)                                  # [S, B, H]

    # Attention of target on interest states (DIN-style bilinear score).
    scores = torch.einsum("sbh,hd,bd->sb", states, params["att"]["w"], target)
    scores = torch.where(ms > 0, scores, -1e30)
    att = torch.softmax(scores, 0)                                # over time

    h = h0
    for s, a, m in zip(states, att, ms):
        h_new = _gru_cell(params["augru"], h, s, att=a)
        h = m[:, None] * h_new + (1 - m[:, None]) * h
    return h


def dien_forward(params: dict, cfg: RecsysConfig,
                 batch: Batch) -> torch.Tensor:
    user, target, hist = _dien_embed(params, cfg, batch)
    interest = dien_interest(params, cfg, target, hist, batch["hist_mask"])
    x = torch.cat([interest, target, user], -1)
    return mlp_apply(params["deep"], x, len(cfg.deep_mlp) + 1, "deep")[:, 0]


# ---------------------------------------------------------------------------
# Uniform API
# ---------------------------------------------------------------------------

_INIT = {"dlrm": init_dlrm, "dcn_v2": init_dcn, "deepfm": init_deepfm,
         "dien": init_dien}
_FWD = {"dlrm": dlrm_forward, "dcn_v2": dcn_forward, "deepfm": deepfm_forward,
        "dien": dien_forward}
#: the top-level parameter groups of each model kind (the reference's
#: nested-dict layout)
PARAM_KEYS = {"dlrm": ("tables", "bot", "top"),
              "dcn_v2": ("tables", "cross", "deep", "final"),
              "deepfm": ("tables", "fm", "deep"),
              "dien": ("tables", "gru", "augru", "att", "deep", "proj")}
_TABLE_PARAMS = ("tables", "fm")   # stored in cfg.param_dtype


def init_params(gen: Generator, cfg: RecsysConfig,
                device: DeviceLike = None) -> dict:
    return _INIT[cfg.model](gen, cfg, device)


def forward(params: dict, cfg: RecsysConfig, batch: Batch) -> torch.Tensor:
    return _FWD[cfg.model](params, cfg, batch)


def loss(params: dict, cfg: RecsysConfig, batch: Batch) -> torch.Tensor:
    return _bce(forward(params, cfg, batch), batch["labels"])


def user_embedding(params: dict, cfg: RecsysConfig,
                   batch: Batch) -> torch.Tensor:
    """User-side tower representation for retrieval scoring [B, embed_dim].

    dcn_v2 / deepfm: the mean of the user's field embeddings, one
    ``embedding_bag_fused(..., "mean")`` launch over the field rows (the
    kernel sums in fp32 and rounds to the table's dtype before the cast to
    ``cfg.dtype``; the two are equal in every config)."""
    if cfg.model == "dlrm":
        dev = params["tables"].device
        return mlp_apply(params["bot"], _on(batch["dense"], dev).to(cfg.dtype),
                         len(cfg.bot_mlp), "bot", final_relu=True)
    if cfg.model == "dien":
        user, target, hist = _dien_embed(params, cfg, batch)
        interest = dien_interest(params, cfg, target, hist, batch["hist_mask"])
        return interest @ params["proj"]["w"][:, : cfg.embed_dim]
    tables = params["tables"]
    gids = to_global_ids(cfg, _on(batch["sparse"], tables.device))
    return seg_ops.embedding_bag_fused(tables, gids, gids.shape[0],
                                       "mean").to(cfg.dtype)


def retrieval_scores(params: dict, cfg: RecsysConfig, batch: Batch,
                     candidate_ids) -> torch.Tensor:
    """Score [B] users against [C] candidate items: one batched matmul.

    candidate_ids are GLOBAL rows into the concatenated table; the gathered
    [C, dim] block is the candidate tower.
    """
    u = user_embedding(params, cfg, batch)                        # [B, d]
    tables = params["tables"]
    cand = tables[_on(candidate_ids, tables.device).long()].to(cfg.dtype)
    d = min(u.shape[-1], cand.shape[-1])
    return u[:, :d] @ cand[:, :d].T                               # [B, C]


def params_from_jax(params_np: Mapping, cfg: RecsysConfig,
                    device: DeviceLike = None) -> dict:
    """Carry weights made by the reference (``repro.models.recsys.
    init_params``, converted to numpy) across, in the same nested-dict
    layout: the tables (and DeepFM's first-order weights) in
    ``cfg.param_dtype``, every other array in ``cfg.dtype``, on ``device``
    (default: CUDA)."""
    dev = resolve_device(device)
    want = PARAM_KEYS[cfg.model]
    if set(params_np) != set(want):
        raise ValueError(f"{cfg.model} parameters have groups {want}, got "
                         f"{tuple(params_np)}")

    def conv(x, dtype):
        if isinstance(x, Mapping):
            return {k: conv(v, dtype) for k, v in x.items()}
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    return {k: conv(v, cfg.param_dtype if k in _TABLE_PARAMS else cfg.dtype)
            for k, v in params_np.items()}
