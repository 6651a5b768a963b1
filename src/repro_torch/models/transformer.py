"""The LMs (TinyLlama, H2O-Danube, Qwen3-MoE, Gemma3, DeepSeek-V3),
mirroring ``repro/models/transformer.py``.

``LMConfig`` carries the reference's fields and defaults, so configs copy
over with only the dtype changed; ``remat`` checkpoints each block in
training, and the fields only the reference's XLA lowering or sharding
reads (``scan_unroll``, ``attn_unroll``, the ``*_spec`` fields,
``xent_mode``, ``bf16_grad_sync``, ``remat_policy``) are kept and do not
change the result, except ``act_spec`` and ``logit_spec``: where the
activations are DTensors, the hidden states after the embedding and each
block, and the logits, are laid out by them (specs of
``configs.common``), as the reference pins them. The model is ``nn.Module``s
(``Transformer`` > ``Block`` > ``GQAttention`` or ``MLAttention``, +
``SwiGLU`` or ``MoE``) whose parameter names follow the reference's tree
(``layers.{i}.attn.wq``, ``layers.{i}.mlp.router``), with a Python loop over
layers. The reference's first ``n_dense_prefix`` layers are a list of their
own (``prefix.{i}``, a dense SwiGLU of ``d_ff`` even where ``cfg.moe`` is
set) ahead of the ``n_scan_layers`` it stacks (``layers.{j}``); a layer's
window and cache are those of its absolute index (``n_dense_prefix + j``
for ``layers.{j}``), as the reference's decode path reads them. So the
hybrid local:global pattern (Gemma3: ``local_global=6``) needs no traced
flag: a global layer has no window, which is what the reference's scan gets
by ORing its per-layer flag into the mask. An MoE layer's router is fp32
whatever ``cfg.dtype`` is (the reference's ``init_moe`` casts it). MLA
layers (``attention="mla"``) take no window and keep full-length latent
caches. DeepSeek's multi-token-prediction head (``cfg.mtp``: ``mtp.proj``
(2D, D), ``mtp.layer``, a dense block, and ``mtp.norm``) is built, drawn and
carried, so the parameter count and tree are the reference's; only the
training loss runs it, so prefill and decode do not.

Entry points (forward, prefill and decode under ``torch.inference_mode``):

* ``init_params(cfg, seed, device)`` -> ``Transformer``, random weights from
  a seeded ``torch.Generator`` in the reference's scheme (normals times
  ``d_model ** -0.5``, norms one); the draws differ from ``jax.random``'s,
  so tests carry the reference's weights across (``models/convert.py``);
* ``forward`` (hidden states), ``prefill`` (last-position logits): full
  sequences, attention through the flash-attention kernel;
* ``init_cache`` + ``decode_step``: one token at a time against per-layer
  caches that are updated in place; a windowed layer's cache is a ring of
  ``min(window, max_len)`` slots, its mask built from the absolute position
  stored in each slot;
* ``loss_fn`` (training): ``Transformer.hidden``'s (hidden, aux), the
  cross-entropy, the MTP term and the aux, differentiable. Weights are
  created frozen (``requires_grad=False``) for serving; training turns them
  on (``train.train_loop.trainable``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import model_device, resolve_device
from ..distributed import sharding
from ..distributed.sharding import split_last
from . import layers as L


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 2
    d_head: int = 64
    d_ff: int = 512
    vocab: int = 1024
    attention: str = "gqa"              # 'gqa' | 'mla'
    mla: Any = None                     # layers.MLAConfig
    moe: Any = None                     # layers.MoEConfig
    n_dense_prefix: int = 0
    window: int | None = None           # sliding-window width (danube)
    local_global: int | None = None     # period P: layer % P == P-1 is global
    local_window: int = 1024
    rope_theta: float = 10000.0
    mtp: bool = False
    mtp_weight: float = 0.3
    dtype: Any = torch.bfloat16
    kv_chunk: int = 1024
    remat: bool = False
    scan_unroll: int = 1
    attn_unroll: int = 1
    act_spec: Any = None
    logit_spec: Any = None
    xent_mode: str = "gather"
    bf16_grad_sync: bool = False
    remat_policy: str = "full"

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - self.n_dense_prefix

    def layer_is_global(self, i: int) -> bool:
        if self.local_global is None:
            return self.window is None
        return i % self.local_global == self.local_global - 1

    def layer_window(self, i: int) -> int | None:
        if self.local_global is not None:
            return None if self.layer_is_global(i) else self.local_window
        return self.window


def _pin(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` laid out by ``spec`` where it is a DTensor and a spec is set
    (the reference's ``with_sharding_constraint``); else ``x``."""
    if spec is None or not sharding.is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, sharding.placements(x.device_mesh, spec))


def _weight(shape, cfg, device, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype or cfg.dtype, device=device),
                        requires_grad=False)


def _ones(n, cfg, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((n,), dtype=cfg.dtype, device=device),
                        requires_grad=False)


class GQAttention(nn.Module):
    def __init__(self, cfg: LMConfig, window: int | None, device):
        super().__init__()
        D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
        self.cfg, self.window = cfg, window
        self.wq = _weight((D, H * dh), cfg, device)
        self.wk = _weight((D, Hkv * dh), cfg, device)
        self.wv = _weight((D, Hkv * dh), cfg, device)
        self.wo = _weight((H * dh, D), cfg, device)

    def params(self) -> dict:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        out, _ = L.gqa_forward(self.params(), x, positions, n_heads=c.n_heads,
                               n_kv=c.n_kv, d_head=c.d_head, rope_theta=c.rope_theta,
                               window=self.window)
        return out

    def decode(self, h: torch.Tensor, pos: torch.Tensor, cache: dict) -> torch.Tensor:
        """h (B, D) at absolute positions pos (B,); writes this token's k, v
        and position into ``cache`` in place and attends over it."""
        c = self.cfg
        B = h.shape[0]
        H, Hkv, dh = c.n_heads, c.n_kv, c.d_head
        w = self.window
        size = cache["k"].shape[1]
        slot = pos % size if w is not None and w <= size else pos
        positions = pos[:, None]
        q = L.rope(split_last(h @ self.wq, H, dh)[:, None], positions, c.rope_theta)
        k = L.rope(split_last(h @ self.wk, Hkv, dh)[:, None], positions, c.rope_theta)
        v = split_last(h @ self.wv, Hkv, dh)[:, None]
        L.write_rows(cache["k"], slot, k[:, 0])
        L.write_rows(cache["v"], slot, v[:, 0])
        L.write_rows(cache["pos"], slot, pos.to(cache["pos"].dtype))
        pc = cache["pos"]
        # the mask straight from the stored absolute positions (ring-safe)
        s = L.gqa_scores(sharding.split_dim(q, 2, Hkv, H // Hkv) * dh ** -0.5,
                          cache["k"])[..., 0, :]                  # (B, Hkv, G, size)
        valid = (pc >= 0) & (pc <= pos[:, None])
        if w is not None:
            valid &= pc > (pos[:, None] - w)
        s = s.masked_fill(~valid[:, None, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", p, cache["v"].float())
        return o.reshape(B, H * dh).to(h.dtype) @ self.wo


class MLAttention(nn.Module):
    """``cfg.mla``'s weights in the reference's layouts: w_dq (D, q_lora),
    q_norm, w_uq (q_lora, H * (dn + dr)), w_dkv (D, r), kv_norm, w_kr (D,
    dr), w_uk (r, H * dn), w_uv (r, H * dv), wo (H * dv, D)."""

    NAMES = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk", "w_uv", "wo")

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        m, D = cfg.mla, cfg.d_model
        H, r = m.n_heads, m.kv_lora_rank
        self.cfg = cfg
        self.w_dq = _weight((D, m.q_lora_rank), cfg, device)
        self.q_norm = _ones(m.q_lora_rank, cfg, device)
        self.w_uq = _weight((m.q_lora_rank, H * (m.qk_nope_dim + m.qk_rope_dim)), cfg, device)
        self.w_dkv = _weight((D, r), cfg, device)
        self.kv_norm = _ones(r, cfg, device)
        self.w_kr = _weight((D, m.qk_rope_dim), cfg, device)
        self.w_uk = _weight((r, H * m.qk_nope_dim), cfg, device)
        self.w_uv = _weight((r, H * m.v_head_dim), cfg, device)
        self.wo = _weight((H * m.v_head_dim, D), cfg, device)

    def params(self) -> dict:
        return {n: getattr(self, n) for n in self.NAMES}

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        return L.mla_forward(self.params(), x, positions, c.mla, rope_theta=c.rope_theta)[0]

    def decode(self, h: torch.Tensor, pos: torch.Tensor, cache: dict) -> torch.Tensor:
        """h (B, D) at absolute positions pos (B,): the latent and RoPE key
        go into slot ``pos`` of the full-length caches, in place."""
        c = self.cfg
        out, _ = L.mla_forward(self.params(), h[:, None], pos[:, None], c.mla,
                               rope_theta=c.rope_theta,
                               cache=(cache["kv_c"], cache["k_rope"]), cache_len=pos)
        return out[:, 0]


class SwiGLU(nn.Module):
    def __init__(self, cfg: LMConfig, d_ff: int, device):
        super().__init__()
        self.w_gate = _weight((cfg.d_model, d_ff), cfg, device)
        self.w_up = _weight((cfg.d_model, d_ff), cfg, device)
        self.w_down = _weight((d_ff, cfg.d_model), cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.swiglu(x, self.w_gate, self.w_up, self.w_down)


class MoE(nn.Module):
    """``cfg.moe``'s experts: router (D, E) fp32, w_gate / w_up (E, D, F),
    w_down (E, F, D), and ``shared`` (a SwiGLU of n_shared * shared_d_ff)
    where n_shared."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        m = self.moe = cfg.moe
        D, E, F = cfg.d_model, m.n_experts, m.d_ff
        self.router = _weight((D, E), cfg, device, torch.float32)
        self.w_gate = _weight((E, D, F), cfg, device)
        self.w_up = _weight((E, D, F), cfg, device)
        self.w_down = _weight((E, F, D), cfg, device)
        self.shared = SwiGLU(cfg, m.shared_d_ff * m.n_shared, device) if m.n_shared else None

    def params(self) -> dict:
        p = {"router": self.router, "w_gate": self.w_gate, "w_up": self.w_up,
             "w_down": self.w_down}
        if self.shared is not None:
            p["shared"] = {"w_gate": self.shared.w_gate, "w_up": self.shared.w_up,
                           "w_down": self.shared.w_down}
        return p

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, D) -> (out (B, S, D), the load-balance aux loss, fp32);
        each batch row is a group of its own (at decode, S = 1: C = 1 and
        nothing drops)."""
        return L.moe_forward(self.params(), x, self.moe)


class Block(nn.Module):
    """Attention (MLA where ``cfg.attention == "mla"``, else GQA with
    ``window``) and the MLP: ``cfg.moe``'s experts, or a SwiGLU of
    ``cfg.d_ff`` where there is none or ``dense_mlp`` (the dense prefix, the
    MTP block)."""

    def __init__(self, cfg: LMConfig, window: int | None, device, dense_mlp: bool = False):
        super().__init__()
        self.attn_norm = _ones(cfg.d_model, cfg, device)
        self.attn = (MLAttention(cfg, device) if cfg.attention == "mla"
                     else GQAttention(cfg, window, device))
        self.mlp_norm = _ones(cfg.d_model, cfg, device)
        self.mlp = (MoE(cfg, device) if cfg.moe is not None and not dense_mlp
                    else SwiGLU(cfg, cfg.d_ff, device))
        self.act_spec = cfg.act_spec

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """-> (x (B, S, D), aux): the MoE's load-balance loss, fp32 0 for a
        dense MLP. ``cfg.act_spec`` also lays out the residual stream
        between attention and the MLP (:func:`_pin`)."""
        x = _pin(x + self.attn(L.rms_norm(x, self.attn_norm), positions), self.act_spec)
        h = L.rms_norm(x, self.mlp_norm)
        if isinstance(self.mlp, MoE):
            m, aux = self.mlp(h)
        else:
            m, aux = self.mlp(h), torch.zeros((), dtype=torch.float32, device=x.device)
        return x + m, aux

    def decode(self, x: torch.Tensor, pos: torch.Tensor, cache: dict) -> torch.Tensor:
        x = x + self.attn.decode(L.rms_norm(x, self.attn_norm), pos, cache)
        h = L.rms_norm(x, self.mlp_norm)
        return x + (self.mlp(h[:, None])[0][:, 0] if isinstance(self.mlp, MoE) else self.mlp(h))


class MTP(nn.Module):
    """The multi-token-prediction head's weights: proj (2D, D), a dense
    global block and a norm. Only the training loss (``loss_fn``) runs
    them; prefill and decode do not."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.proj = _weight((2 * cfg.d_model, cfg.d_model), cfg, device)
        self.layer = Block(cfg, None, device, dense_mlp=True)
        self.norm = _ones(cfg.d_model, cfg, device)


class Transformer(nn.Module):
    """Embedding, the ``n_dense_prefix`` dense blocks (``prefix``) and the
    ``n_scan_layers`` after them (``layers``), final norm, LM head, and the
    MTP head's weights where ``cfg.mtp``; weights left uninitialised
    (``init_params`` or ``convert.lm_params_from_numpy`` fill them)."""

    def __init__(self, cfg: LMConfig, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        self.embed = _weight((cfg.vocab, cfg.d_model), cfg, device)
        self.final_norm = _ones(cfg.d_model, cfg, device)
        self.lm_head = _weight((cfg.d_model, cfg.vocab), cfg, device)
        self.prefix = nn.ModuleList(Block(cfg, cfg.layer_window(i), device, dense_mlp=True)
                                    for i in range(cfg.n_dense_prefix))
        self.layers = nn.ModuleList(Block(cfg, cfg.layer_window(cfg.n_dense_prefix + j), device)
                                    for j in range(cfg.n_scan_layers))
        self.mtp = MTP(cfg, device) if cfg.mtp else None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def blocks(self) -> list:
        """Every block in order: the dense prefix, then the stacked layers."""
        return [*self.prefix, *self.layers]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final-normed hidden states (B, S, D)."""
        return self.hidden(tokens)[0]

    def hidden(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (final-normed hidden (B, S, D), aux): the
        reference's ``forward``, aux the fp32 sum of the MoE layers'
        load-balance losses. Where ``cfg.remat`` is set and autograd
        records, each block is checkpointed (``torch.utils.checkpoint``,
        non-reentrant): its activations are recomputed in the backward."""
        B, S = tokens.shape
        act = self.cfg.act_spec
        x = _pin(sharding.take_rows(self.embed, tokens), act)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.blocks():
            if remat:
                x, a = checkpoint(block, x, positions, use_reentrant=False)
            else:
                x, a = block(x, positions)
            x = _pin(x, act)
            aux = aux + a
        return L.rms_norm(x, self.final_norm), aux

    def decode(self, token: torch.Tensor, pos: torch.Tensor, caches: list) -> torch.Tensor:
        """token (B,), pos (B,) -> logits (B, V) fp32; caches (one a block,
        in ``blocks()`` order) updated in place."""
        x = sharding.take_rows(self.embed, token)
        for block, cache in zip(self.blocks(), caches, strict=True):
            x = block.decode(x, pos, cache)
        return (L.rms_norm(x, self.final_norm) @ self.lm_head).float()


DRAW_CHUNK = 2**30


def param_count(model: Transformer) -> int:
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def init_params(cfg: LMConfig, seed: int = 0, device="cuda", shard=None) -> Transformer:
    """A ``Transformer`` with random weights drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: every matrix standard normal
    times ``d_model ** -0.5`` (drawn in fp32, then cast to the parameter's
    dtype: ``cfg.dtype``, fp32 for a router), every norm scale one. A
    parameter of more than ``DRAW_CHUNK`` elements (DeepSeek-V3's experts,
    3.8e9 each) is drawn in slices along its first axis, so the fp32 draw
    never needs a second copy of it.

    With ``shard`` ((name, whole tensor) -> the tensor to keep), the model
    is built on ``meta`` and each parameter is drawn whole in turn, the same
    values, and replaced by ``shard``'s result: a rank that keeps its shards
    holds one whole parameter at a time (``launch/train.py``)."""
    device = resolve_device(device)
    model = Transformer(cfg, "meta" if shard else device)
    g = torch.Generator(device=device).manual_seed(seed)
    s = cfg.d_model ** -0.5
    for name, p in list(model.named_parameters()):
        w = torch.empty(p.shape, dtype=p.dtype, device=device) if shard else p
        if name.endswith("norm"):
            w.fill_(1)
        else:
            rows = (max(1, DRAW_CHUNK // max(1, w[0].numel())) if w.numel() > DRAW_CHUNK
                    else len(w))
            for part in w.split(rows):
                part.copy_(torch.randn(part.shape, generator=g, device=device).mul_(s))
        if shard:
            owner, _, leaf = name.rpartition(".")
            model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
                shard(name, w), requires_grad=False)
    return model


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's ``_sharded_xent``: the mean over valid labels (>= 0;
    -100 is ignored) of logsumexp(logits) - the gold logit; 0 where there is
    none. Its ``xent_mode="onehot"`` gives identical values, so the port
    keeps one form."""
    valid = labels >= 0
    if sharding.is_dtensor(logits):   # the vocab axis may be sharded
        gold = sharding.gather_last(logits, labels)
    else:
        gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = torch.where(valid, torch.logsumexp(logits, dim=-1) - gold, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def loss_fn(model: Transformer, batch: dict) -> tuple[torch.Tensor, dict]:
    """The reference's ``loss_fn``: batch {tokens, labels} (B, S), labels
    -100 = ignore -> (loss, {"nll", "aux"}). loss = the LM head's
    cross-entropy (fp32 logits) + aux (the MoE layers' load-balance sum) +,
    where ``cfg.mtp``, ``mtp_weight`` times the depth-1 MTP head's
    cross-entropy: ``rms_norm(h, mtp.norm)`` beside the next token's
    embedding, through ``mtp.proj`` and ``mtp.layer`` (a global block), to
    the LM head, against the labels rolled by one with the last -100."""
    cfg = model.cfg
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux = model.hidden(tokens)
    nll = xent(_pin((h @ model.lm_head).float(), cfg.logit_spec), labels)
    loss = nll
    if cfg.mtp:
        mtp = model.mtp
        B, S = tokens.shape
        emb_next = sharding.take_rows(model.embed, torch.roll(tokens, -1, dims=1))
        hm = torch.cat([L.rms_norm(h, mtp.norm), emb_next], dim=-1) @ mtp.proj
        hm, _ = mtp.layer(hm, torch.arange(S, device=tokens.device).expand(B, S))
        last = torch.arange(S, device=tokens.device) == S - 1
        labels_m = torch.where(last, -100, torch.roll(labels, -1, dims=1))
        loss = loss + cfg.mtp_weight * xent(_pin((hm @ model.lm_head).float(),
                                                 cfg.logit_spec), labels_m)
    return loss + aux, {"nll": nll, "aux": aux}


@torch.inference_mode()
def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> hidden (B, S, D)."""
    return model(tokens)


@torch.inference_mode()
def prefill(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward returning last-position logits (B, V) fp32
    (the cache is not returned, as in the reference)."""
    h = model(tokens)
    return (h[:, -1] @ model.lm_head).float()


def init_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda") -> list[dict]:
    """Per-layer caches, by absolute layer index: MLA {kv_c: (B, max_len,
    r), k_rope: (B, max_len, dr)}; GQA {k, v: (B, size, Hkv, dh), pos: (B,
    size) int32 of -1}, a windowed layer's size ``min(window, max_len)``."""
    device = model_device(device)
    caches = []
    for i in range(cfg.n_layers):
        w = cfg.layer_window(i)
        size = max_len if w is None else min(w, max_len)
        if cfg.attention == "mla":
            m = cfg.mla
            caches.append({
                "kv_c": torch.zeros((batch, size, m.kv_lora_rank), dtype=cfg.dtype,
                                    device=device),
                "k_rope": torch.zeros((batch, size, m.qk_rope_dim), dtype=cfg.dtype,
                                      device=device),
            })
            continue
        kv = (batch, size, cfg.n_kv, cfg.d_head)
        caches.append({
            "k": torch.zeros(kv, dtype=cfg.dtype, device=device),
            "v": torch.zeros(kv, dtype=cfg.dtype, device=device),
            "pos": torch.full((batch, size), -1, dtype=torch.int32, device=device),
        })
    return caches


@torch.inference_mode()
def decode_step(model: Transformer, token: torch.Tensor, pos: torch.Tensor,
                caches: list) -> torch.Tensor:
    """token (B,), pos (B,) -> logits (B, V) fp32: one autoregressive step;
    ``caches`` are updated in place."""
    return model.decode(token, pos, caches)
