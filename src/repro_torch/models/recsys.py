"""RecSys architectures on the port, as ``repro/models/recsys.py``: DLRM
(MLPerf), DeepFM, AutoInt, BERT4Rec, and the two retrieval scorers.

The hot path is the sparse embedding lookup: a row gather per field
(``table[ids]``), and for bags :func:`embedding_bag` (gather, then
``index_add_`` / ``scatter_reduce_`` over the bag ids), as the reference
builds it from ``jnp.take`` and ``segment_sum``. No Pallas kernel computes
any of these models in the reference, so each stays plain PyTorch here:
AutoInt's and BERT4Rec's attention is ``einsum`` + softmax, as there
(BERT4Rec's key-padding mask and head dim 32 are outside
``ops.flash_attention`` anyway). The products are fp32; the callers keep
TF32 off, which the tolerances assume.

The models are ``nn.Module``s whose parameter names are the reference's
tree flattened (``tables.{i}``, ``bot.{i}.w``, ``blocks.{i}.wq``, ...), so
``models/convert.py`` carries the reference's weights across by name.
Weights are created frozen (serving). :func:`init_params` draws them from
a seeded ``torch.Generator`` on the model's device in the reference's
scheme (normals times ``fan_in ** -0.5``; an embedding table of ``v`` rows
times ``v ** -0.25``; BERT4Rec's embeddings times ``D ** -0.5``; biases 0,
norm scales 1): the law of the reference's init, not its draws.

``retrieval_cand`` (top-k of 1M items for one query) is served by
:func:`retrieval_score_exact` (the exact scan, ``distance_matrix`` on the
card) and :func:`retrieval_score_ann` (the paper's graph index: a beam over
a KGraph + GD graph of the items under the inner product).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .._device import model_device
from ..distributed.sharding import take_rows
from .layers import rms_norm


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int, mode: str = "sum") -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` as the reference builds it: rows
    ``table[ids]`` (L, d) reduced into ``num_segments`` bags by
    ``segment_ids`` (L,). ``sum``, ``mean`` (sum over max(count, 1)) or
    ``max``; an empty bag is 0 in every mode (the reference's ``isfinite``
    after ``segment_max``)."""
    rows = table[ids.long()]
    seg = segment_ids.long()
    shape = (num_segments, table.shape[1])
    if mode == "max":
        out = torch.full(shape, -math.inf, dtype=table.dtype, device=table.device)
        out.scatter_reduce_(0, seg[:, None].expand_as(rows), rows, reduce="amax")
        return torch.where(torch.isfinite(out), out, 0.0)
    out = torch.zeros(shape, dtype=table.dtype, device=table.device).index_add_(0, seg, rows)
    if mode == "mean":
        cnt = torch.bincount(seg, minlength=num_segments).to(table.dtype)
        out = out / cnt.clamp_min(1.0)[:, None]
    elif mode != "sum":
        raise ValueError(f"embedding_bag mode {mode!r}: sum, mean or max")
    return out


# -- parameters -----------------------------------------------------------------


def _param(shape, dtype, device, fill: float | None = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """One MLP layer: ``x @ w + b``, w (d_in, d_out), b (d_out,) zeros."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device, 0.0)


def _mlp_layers(dims, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(Dense(dims[i], dims[i + 1], dtype, device) for i in range(len(dims) - 1))


def _mlp(layers: nn.ModuleList, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i, lay in enumerate(layers):
        x = x @ lay.w + lay.b
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def _tables(vocab_sizes, dim, dtype, device) -> nn.ParameterList:
    return nn.ParameterList(_param((v, dim), dtype, device) for v in vocab_sizes)


def _lookup(tables, sparse_ids: torch.Tensor) -> list[torch.Tensor]:
    ids = sparse_ids.long()
    return [take_rows(t, ids[:, i]) for i, t in enumerate(tables)]


class _Model(nn.Module):
    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_std(self, name: str, p: torch.Tensor) -> float | None:
        """The std of ``name``'s random init, or None for a constant."""
        if name.startswith(("tables.", "first.")):
            return p.shape[0] ** -0.25
        if p.dim() == 2 or name == "head":
            return p.shape[0] ** -0.5
        return None


# -- DLRM (MLPerf config) ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    vocab_sizes: tuple[int, ...] = ()   # one per sparse field (26 for Criteo)
    embed_dim: int = 128
    bot_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    dtype: Any = torch.float32


class DLRM(_Model):
    def __init__(self, cfg: DLRMConfig, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        n_f = len(cfg.vocab_sizes) + 1
        self.tables = _tables(cfg.vocab_sizes, cfg.embed_dim, cfg.dtype, device)
        self.bot = _mlp_layers((cfg.n_dense,) + cfg.bot_mlp, cfg.dtype, device)
        self.top = _mlp_layers((n_f * (n_f - 1) // 2 + cfg.bot_mlp[-1],) + cfg.top_mlp,
                               cfg.dtype, device)

    def forward(self, dense: torch.Tensor, sparse_ids: torch.Tensor,
                rows: list | None = None) -> torch.Tensor:
        """dense (B, n_dense), sparse_ids (B, F) -> logits (B,): the dot
        interaction of the bottom MLP's output and the F embeddings, its
        strict upper triangle in row-major order (``triu_indices(F + 1,
        k=1)``). ``rows`` passes the gathered embedding rows instead of
        looking them up (the reference's sparse-update step)."""
        d = _mlp(self.bot, dense.to(self.cfg.dtype), final_act=True)
        embs = rows if rows is not None else _lookup(self.tables, sparse_ids)
        feats = torch.stack([d, *embs], dim=1)                       # (B, F, D)
        inter = torch.bmm(feats, feats.transpose(1, 2))               # (B, F, F)
        fi, gi = torch.triu_indices(feats.shape[1], feats.shape[1], 1, device=feats.device)
        return _mlp(self.top, torch.cat([d, inter[:, fi, gi]], dim=1))[:, 0]


# -- DeepFM --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    vocab_sizes: tuple[int, ...] = ()   # 39 fields for Criteo-full
    embed_dim: int = 10
    mlp: tuple[int, ...] = (400, 400, 400)
    dtype: Any = torch.float32


class DeepFM(_Model):
    def __init__(self, cfg: DeepFMConfig, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        F_ = len(cfg.vocab_sizes)
        self.tables = _tables(cfg.vocab_sizes, cfg.embed_dim, cfg.dtype, device)
        self.first = nn.ParameterList(_param((v,), cfg.dtype, device) for v in cfg.vocab_sizes)
        self.mlp = _mlp_layers((F_ * cfg.embed_dim,) + cfg.mlp + (1,), cfg.dtype, device)
        self.bias = _param((), cfg.dtype, device, 0.0)

    def forward(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        """sparse_ids (B, F) -> logits (B,): bias + first order + FM second
        order (0.5 ((sum v)^2 - sum v^2)) + the deep branch, which shares
        the embeddings."""
        embs = torch.stack(_lookup(self.tables, sparse_ids), dim=1)  # (B, F, d)
        first = sum(_lookup(self.first, sparse_ids))
        s = embs.sum(dim=1)
        fm2 = 0.5 * (s.square() - embs.square().sum(dim=1)).sum(dim=-1)
        deep = _mlp(self.mlp, embs.reshape(embs.shape[0], -1))[:, 0]
        return self.bias + first + fm2 + deep


# -- AutoInt ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    vocab_sizes: tuple[int, ...] = ()
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    dtype: Any = torch.float32


class AutoIntLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        for name in ("wq", "wk", "wv", "wres"):
            setattr(self, name, _param((d_in, d_out), dtype, device))


class AutoInt(_Model):
    def __init__(self, cfg: AutoIntConfig, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        d_out = cfg.n_heads * cfg.d_attn
        self.tables = _tables(cfg.vocab_sizes, cfg.embed_dim, cfg.dtype, device)
        self.layers = nn.ModuleList(
            AutoIntLayer(cfg.embed_dim if i == 0 else d_out, d_out, cfg.dtype, device)
            for i in range(cfg.n_attn_layers))
        d_last = d_out if cfg.n_attn_layers else cfg.embed_dim
        self.head = _param((len(cfg.vocab_sizes) * d_last,), cfg.dtype, device)

    def forward(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        """sparse_ids (B, F) -> logits (B,): multi-head self-attention over
        the F field embeddings with a residual projection and ReLU per
        layer, then a linear head over the flattened fields."""
        cfg = self.cfg
        h = torch.stack(_lookup(self.tables, sparse_ids), dim=1)
        for lp in self.layers:
            B, F_, _ = h.shape
            q, k, v = ((h @ w).reshape(B, F_, cfg.n_heads, cfg.d_attn)
                       for w in (lp.wq, lp.wk, lp.wv))
            s = torch.einsum("bfhd,bghd->bhfg", q, k) * cfg.d_attn ** -0.5
            o = torch.einsum("bhfg,bghd->bfhd", s.softmax(dim=-1), v).reshape(B, F_, -1)
            h = torch.relu(o + h @ lp.wres)
        return (h.reshape(h.shape[0], -1) * self.head).sum(dim=-1)


# -- BERT4Rec ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 54546           # ML-20M items; +1 mask +1 pad appended
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    dtype: Any = torch.float32

    @property
    def vocab(self) -> int:
        return self.n_items + 2

    @property
    def mask_token(self) -> int:
        return self.n_items

    @property
    def pad_token(self) -> int:
        return self.n_items + 1


class Bert4RecBlock(nn.Module):
    def __init__(self, D: int, dtype, device):
        super().__init__()
        self.ln1 = _param((D,), dtype, device, 1.0)
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _param((D, D), dtype, device))
        self.ln2 = _param((D,), dtype, device, 1.0)
        self.w1 = _param((D, 4 * D), dtype, device)
        self.w2 = _param((4 * D, D), dtype, device)


class Bert4Rec(_Model):
    def __init__(self, cfg: Bert4RecConfig, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        D = cfg.embed_dim
        self.item_emb = _param((cfg.vocab, D), cfg.dtype, device)
        self.pos_emb = _param((cfg.seq_len, D), cfg.dtype, device)
        self.blocks = nn.ModuleList(Bert4RecBlock(D, cfg.dtype, device)
                                    for _ in range(cfg.n_blocks))
        self.final_ln = _param((D,), cfg.dtype, device, 1.0)

    def init_std(self, name: str, p: torch.Tensor) -> float | None:
        if name in ("item_emb", "pos_emb"):
            return self.cfg.embed_dim ** -0.5
        return super().init_std(name, p)

    def forward(self, item_seq: torch.Tensor) -> torch.Tensor:
        """item_seq (B, S) -> hidden (B, S, D). Bidirectional (no causal
        mask); pad keys are -inf before the softmax; RMS norms with eps 1e-6
        inside the rsqrt; the MLP's GELU is the tanh approximation
        (``jax.nn.gelu``'s default)."""
        cfg = self.cfg
        B, S = item_seq.shape
        H = cfg.n_heads
        dh = cfg.embed_dim // H
        h = take_rows(self.item_emb, item_seq.long()) + self.pos_emb[None, :S]
        pad = (item_seq == cfg.pad_token)[:, None, None, :]
        for bp in self.blocks:
            x = rms_norm(h, bp.ln1)
            q, k, v = ((x @ w).reshape(B, S, H, dh) for w in (bp.wq, bp.wk, bp.wv))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
            p = torch.where(pad, -math.inf, s).softmax(dim=-1)
            h = h + torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, -1) @ bp.wo
            x = rms_norm(h, bp.ln2)
            h = h + F.gelu(x @ bp.w1, approximate="tanh") @ bp.w2
        return rms_norm(h, self.final_ln)


def bert4rec_loss(model: Bert4Rec, item_seq: torch.Tensor, masked_pos: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Masked-item prediction over a fixed count M of masked positions a
    row (masked_pos (B, M), labels (B, M), -100 = an unused slot): the mean
    over valid slots of logsumexp - gold of the fp32 (B, M, V) logits."""
    h = model(item_seq)
    hm = h.gather(1, masked_pos.long()[..., None].expand(-1, -1, h.shape[-1]))
    logits = (hm @ model.item_emb.T).float()
    valid = labels >= 0
    gold = logits.gather(-1, labels.long().clamp_min(0)[..., None])[..., 0]
    nll = torch.where(valid, torch.logsumexp(logits, dim=-1) - gold, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def next_item_scores(model: Bert4Rec, item_seq: torch.Tensor) -> torch.Tensor:
    """The serve step: every item's score at the last position,
    ``h[:, -1] @ item_emb.T`` in fp32 (B, V)."""
    return (model(item_seq)[:, -1] @ model.item_emb.T).float()


# -- construction --------------------------------------------------------------------


MODELS = {DLRMConfig: DLRM, DeepFMConfig: DeepFM, AutoIntConfig: AutoInt,
          Bert4RecConfig: Bert4Rec}


def build(cfg, device="cuda") -> _Model:
    """The (uninitialised) model of a recsys config."""
    return MODELS[type(cfg)](cfg, device)


@torch.no_grad()
def init_params(cfg, seed: int = 0, device="cuda") -> _Model:
    """The model of ``cfg`` with random weights drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, in parameter order (module
    docstring)."""
    model = build(cfg, device)
    return draw_weights(model, seed)


@torch.no_grad()
def draw_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill each parameter whose ``init_std`` is not None with normals of
    that std, from one generator on the model's device."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        std = model.init_std(name, p)
        if std is not None:
            p.normal_(0.0, std, generator=g)
    return model


# -- retrieval scoring (the paper's workload) ----------------------------------------


def retrieval_score_exact(query_emb: torch.Tensor, item_embs: torch.Tensor, k: int = 100):
    """(B, d) x (n, d) -> (dists (B, k), ids (B, k)), the top-k by inner
    product (dists are -dot), by the exact scan."""
    from ..core.bruteforce import exact_search

    return exact_search(query_emb, item_embs, k, metric="ip")


def retrieval_score_ann(query_emb: torch.Tensor, item_embs: torch.Tensor,
                        graph_neighbors: torch.Tensor, k: int = 100, ef: int = 128,
                        generator: torch.Generator | None = None,
                        entries: torch.Tensor | None = None):
    """Graph-ANN backend: the beam over a KGraph + GD index of the items
    under ``ip`` from ``min(16, ef)`` random entries a query (drawn from
    ``generator``, seed 0 on the items' device by default) or from the
    given ``entries`` (B, E). Returns the beam's ``SearchResult``: its
    ``dists`` and ``ids`` are the reference's (dists, ids) pair, and it also
    carries ``n_comps`` and ``n_steps``."""
    from ..core.beam_search import beam_search, random_entries

    if entries is None:
        if generator is None:
            generator = torch.Generator(device=item_embs.device).manual_seed(0)
        entries = random_entries(generator, item_embs.shape[0], query_emb.shape[0],
                                 min(16, ef))
    return beam_search(query_emb, item_embs, graph_neighbors, entries, ef=ef, k=k,
                       metric="ip")
