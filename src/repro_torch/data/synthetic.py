"""Synthetic ANN datasets (paper Tab. I), as ``repro.data.synthetic``.

Uniform RAND* sets, plus *manifold* stand-ins for the real-world corpora:
points drawn on a low-dimensional latent manifold and lifted nonlinearly
into R^d, matching each corpus's (n, d, LID) profile (SIFT1M: d=128,
GIST1M: d=960, GloVe1M: d=100). Nothing is downloaded.

Every draw comes from a ``torch.Generator`` on the target device, so a
10M-row set is drawn where it is used, never built on the host and copied.
The lift is split from its draws (:func:`manifold_lift`), so the tests can
feed it the same numpy draws as the reference's formula. The draws differ
from ``jax.random``'s: a dataset agrees with the reference's in its law
(LID, ``tab1_datasets``), not bit for bit.

The LM token stream (``lm_batch``, ``lm_batch_for_step``) is the
reference's affine-recurrent stream with noise; its draws come from a CPU
``torch.Generator`` seeded from (seed, step) and are split from the formula
(:func:`lm_tokens`), so the tests can feed it the reference's own
``jax.random`` draws and get its tokens and labels bit for bit.

The recsys and GNN substrates (``recsys_batch``, ``bert4rec_batch``,
``sbm_graph``) draw from an explicit ``torch.Generator`` on its device, and
each is split from its draws (``recsys_from_draws``, ``bert4rec_from_draws``,
``sbm_from_draws``), so the tests build the reference's batches and graphs
bit for bit from its ``jax.random`` draws. ``edges_to_csr`` runs on the
edges' device (a stable sort: the reference's host argsort, bit for bit).
"""
from __future__ import annotations

import math
import zlib

import torch

from .._device import resolve_device


def rand_dataset(generator: torch.Generator, n: int, d: int) -> torch.Tensor:
    """Paper's synthetic family: each dim uniform in [0, 1), on the
    generator's device."""
    return torch.rand((n, d), generator=generator, device=generator.device)


def manifold_lift(z: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  eps: torch.Tensor, noise: float = 0.01) -> torch.Tensor:
    """tanh(z @ w1) @ w2 + noise * eps: latent points z (n, latent) through
    the 2-layer random lift (w1 (latent, 2 latent), w2 (2 latent, d)), plus
    isotropic noise eps (n, d)."""
    x = torch.tanh(z @ w1) @ w2
    return x.add_(eps, alpha=noise)


def manifold_dataset(generator: torch.Generator, n: int, d: int, latent_dim: int,
                     noise: float = 0.01) -> torch.Tensor:
    """Low-LID data embedded in R^d: latent uniform -> 2-layer random tanh
    lift -> small isotropic noise. Draws z, w1, w2 and the noise, in that
    order, from ``generator``."""
    dev = generator.device
    z = torch.rand((n, latent_dim), generator=generator, device=dev)
    w1 = torch.randn((latent_dim, 2 * latent_dim), generator=generator,
                     device=dev) / math.sqrt(latent_dim)
    w2 = torch.randn((2 * latent_dim, d), generator=generator,
                     device=dev) / math.sqrt(2 * latent_dim)
    eps = torch.randn((n, d), generator=generator, device=dev)
    return manifold_lift(z, w1, w2, eps, noise)


PAPER_DATASETS: dict[str, dict] = {
    # name: (n, d, latent/None, metric, paper LID)
    "RAND10M4D": dict(n=10_000_000, d=4, latent=None, metric="l2", paper_lid=3.6),
    "RAND10M8D": dict(n=10_000_000, d=8, latent=None, metric="l2", paper_lid=6.5),
    "RAND10M16D": dict(n=10_000_000, d=16, latent=None, metric="l2", paper_lid=11.6),
    "RAND10M32D": dict(n=10_000_000, d=32, latent=None, metric="l2", paper_lid=19.4),
    "RAND1M": dict(n=1_000_000, d=100, latent=None, metric="l2", paper_lid=48.9),
    "SIFT1M": dict(n=1_000_000, d=128, latent=16, metric="l2", paper_lid=16.3),
    "GIST1M": dict(n=1_000_000, d=960, latent=38, metric="l2", paper_lid=38.1),
    "GLOVE1M": dict(n=1_200_000, d=100, latent=40, metric="cos", paper_lid=39.5),
}


def default_seed(name: str) -> int:
    """The seed of a dataset drawn without one: crc32 of its name. The
    reference keys on ``hash(name)``, which Python salts per process for
    str unless PYTHONHASHSEED is set, so its default world changes from run
    to run; this one does not."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def make_ann_dataset(name: str, seed: int | None = None, scale: float = 1.0,
                     n_queries: int = 1000, device="cuda"):
    """Returns (base (n, d), queries (q, d), metric) on ``device``. ``scale``
    shrinks n (n = max(int(n * scale), 1000)); the default ``seed`` is
    :func:`default_seed`. Manifold queries are drawn from the same manifold
    as the base, as the rows after it."""
    spec = PAPER_DATASETS[name]
    if seed is None:
        seed = default_seed(name)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = max(int(spec["n"] * scale), 1000)
    if spec["latent"] is None:
        base = rand_dataset(gen, n, spec["d"])
        queries = rand_dataset(gen, n_queries, spec["d"])
    else:
        both = manifold_dataset(gen, n + n_queries, spec["d"], spec["latent"])
        base, queries = both[:n], both[n:n + n_queries].clone()
    return base, queries, spec["metric"]


# -- LM token streams ---------------------------------------------------------


def lm_tokens(a: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
              rnd: torch.Tensor, vocab: int) -> dict:
    """The reference's learnable stream from its draws: a (B, 1) steps in
    [1, 17), start (B, 1) in [0, vocab), noise (B, S) bool, rnd (B, S) in
    [0, vocab) -> {tokens: (start + a * t) % vocab, replaced by rnd where
    noise, int32; labels: tokens shifted left by one, the last -100}."""
    t = torch.arange(noise.shape[1], device=noise.device)[None, :]
    toks = torch.where(noise, rnd, (start + a * t) % vocab).to(torch.int32)
    labels = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -100)], dim=1)
    return {"tokens": toks, "labels": labels}


def lm_batch(generator: torch.Generator, batch: int, seq: int, vocab: int) -> dict:
    """A batch of the stream, its draws (a, start, noise at p = 0.05, rnd)
    from ``generator`` in that order, on its device."""
    dev = generator.device
    a = torch.randint(1, 17, (batch, 1), generator=generator, device=dev)
    start = torch.randint(0, vocab, (batch, 1), generator=generator, device=dev)
    noise = torch.rand((batch, seq), generator=generator, device=dev) < 0.05
    rnd = torch.randint(0, vocab, (batch, seq), generator=generator, device=dev)
    return lm_tokens(a, start, noise, rnd, vocab)


def step_seed(seed: int, step: int) -> int:
    """The generator seed of (seed, step), as the reference folds the step
    into its key."""
    return (seed * 0x9E3779B1 + 0x632BE5AB * (step + 1)) % (2**63 - 1)


def lm_batch_for_step(seed: int, step: int, batch: int, seq: int, vocab: int,
                      device="cpu") -> dict:
    """The batch of ``step``: a pure function of (seed, step), drawn on the
    CPU (so it is the same on every device and topology), then moved to
    ``device``."""
    gen = torch.Generator().manual_seed(step_seed(seed, step))
    out = lm_batch(gen, batch, seq, vocab)
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in out.items()}


# -- recsys batches -------------------------------------------------------------


def recsys_from_draws(raw: torch.Tensor, dense: torch.Tensor | None, u: torch.Tensor,
                      vocab_sizes: tuple[int, ...]) -> dict:
    """The reference's Criteo-like batch from its draws: raw (B, F) ids in
    [0, 2**30), dense (B, n_dense) normals or None, u (B,) uniforms ->
    {sparse: raw % vocab (int32), dense, label}, the label 1.0 where u is
    below sigmoid of the planted teacher sum_f sin(id * phi_f) / sqrt(F)
    (+ sum(dense) / sqrt(n_dense)), phi = linspace(0.1, 1.7, F)."""
    F = len(vocab_sizes)
    sparse = raw % torch.tensor(vocab_sizes, device=raw.device)[None, :]
    phi = torch.linspace(0.1, 1.7, F, device=raw.device)[None, :]
    teacher = torch.sin(sparse.float() * phi).sum(dim=1) / math.sqrt(F)
    out = {"sparse": sparse.to(torch.int32)}
    if dense is not None:
        teacher = teacher + dense.sum(dim=1) / math.sqrt(dense.shape[1])
        out["dense"] = dense
    out["label"] = (u < torch.sigmoid(teacher)).float()
    return out


def recsys_batch(generator: torch.Generator, batch: int, vocab_sizes: tuple[int, ...],
                 n_dense: int = 0) -> dict:
    """A batch of ``batch`` rows on the generator's device; draws raw ids,
    the dense features (where ``n_dense``) and the label uniforms, in that
    order."""
    dev = generator.device
    raw = torch.randint(0, 1 << 30, (batch, len(vocab_sizes)), generator=generator,
                        device=dev)
    dense = (torch.randn((batch, n_dense), generator=generator, device=dev)
             if n_dense else None)
    u = torch.rand((batch,), generator=generator, device=dev)
    return recsys_from_draws(raw, dense, u, vocab_sizes)


def bert4rec_from_draws(step_sz: torch.Tensor, start: torch.Tensor, masked: torch.Tensor,
                        n_items: int, mask_token: int) -> dict:
    """Markov item sequences (start + step_sz * t) % n_items (step_sz,
    start (B, 1)) with Bernoulli cloze masking (masked (B, S) bool) ->
    {items: mask_token where masked, labels: the item there, else -100},
    int32."""
    t = torch.arange(masked.shape[1], device=masked.device)[None, :]
    seqs = (start + step_sz * t) % n_items
    return {"items": torch.where(masked, mask_token, seqs).to(torch.int32),
            "labels": torch.where(masked, seqs, -100).to(torch.int32)}


def bert4rec_batch(generator: torch.Generator, batch: int, seq: int, n_items: int,
                   mask_token: int, mask_prob: float = 0.15) -> dict:
    """A batch on the generator's device; draws step sizes in [1, 7),
    starts in [0, n_items) and the mask (uniform < mask_prob)."""
    dev = generator.device
    step_sz = torch.randint(1, 7, (batch, 1), generator=generator, device=dev)
    start = torch.randint(0, n_items, (batch, 1), generator=generator, device=dev)
    masked = torch.rand((batch, seq), generator=generator, device=dev) < mask_prob
    return bert4rec_from_draws(step_sz, start, masked, n_items, mask_token)


# -- GNN graphs ------------------------------------------------------------------


def sbm_from_draws(labels: torch.Tensor, src: torch.Tensor, dst_rand: torch.Tensor,
                   u: torch.Tensor, centers: torch.Tensor, noise: torch.Tensor,
                   p_in: float = 0.05, p_out: float = 0.005) -> dict:
    """The reference's stochastic block model from its draws: labels (n,),
    edge sources and candidate destinations (E,), uniforms u (E,), class
    centers (C, d) and noise (n, d). A candidate of another class is kept
    with probability p_out / p_in (of the same class always), a rejected
    one turns into a self loop -> {feats: centers[labels] + 0.5 noise,
    edges (E, 2) int32, labels int32}."""
    same = labels[src] == labels[dst_rand]
    accept = u < torch.where(same, 1.0, p_out / p_in)
    dst = torch.where(accept, dst_rand, src)
    return {"feats": centers[labels] + 0.5 * noise,
            "edges": torch.stack([src, dst], dim=1).to(torch.int32),
            "labels": labels.to(torch.int32)}


def sbm_graph(generator: torch.Generator, n: int, n_classes: int, d_feat: int,
              p_in: float = 0.05, p_out: float = 0.005, avg_deg: int = 10) -> dict:
    """An SBM graph of n * avg_deg edges with class-correlated features on
    the generator's device; draws labels, sources, candidates, uniforms,
    centers and noise, in that order."""
    dev = generator.device
    E = n * avg_deg

    def ints(hi, size):
        return torch.randint(0, hi, size, generator=generator, device=dev, dtype=torch.int32)

    labels = ints(n_classes, (n,))
    src, dst_rand = ints(n, (E,)), ints(n, (E,))
    u = torch.rand((E,), generator=generator, device=dev)
    centers = torch.randn((n_classes, d_feat), generator=generator, device=dev)
    noise = torch.randn((n, d_feat), generator=generator, device=dev)
    return sbm_from_draws(labels, src, dst_rand, u, centers, noise, p_in, p_out)


def edges_to_csr(edges: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, 2) src -> dst edges -> CSR (indptr (n + 1,), indices (E,)), int32,
    on the edges' device: the destinations in a stable sort by source, so
    each node's neighbors keep the edge list's order."""
    src = edges[:, 0]
    order = torch.sort(src, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=edges.device)
    indptr[1:] = torch.cumsum(torch.bincount(src.long(), minlength=n), 0)
    return indptr, edges[order, 1].to(torch.int32)
