"""Product quantization [Jégou TPAMI'11] — the paper's quantization baseline.

Vectors are split into M sub-vectors, each quantized against a K-word
codebook (K <= 256: the codes are uint8) trained with Lloyd's k-means.
Search is asymmetric distance computation: per query, an (M, K) LUT of
sub-distances, a scan of every code row through the ``pq_adc`` kernel, and
an exact rerank of the best candidates.

The reference trains all M sub-spaces at once under a vmap; here they are
trained one after another, and every (n, K) distance or assignment matrix
is built in row chunks, so training at n = 1M stays within a few hundred MB.
Cluster sums are one-hot matmuls per chunk, never float atomics, so a
same-seed rebuild gives identical codebooks on the card too. Random draws
come from ``torch.Generator``s seeded from ints (``derive_pq_key`` and
``derive_opq_key`` fold the reference's crc32 tags into the seed), so
codebooks differ from the reference's; given the reference's codebooks,
encoding, LUTs, ADC and search agree with it.
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import torch

from ..core.topk import topk_smallest

MAX_K = 256        # codewords per sub-quantizer: the codes are uint8
CHUNK = 65536      # rows per (chunk, K) distance / one-hot block
SEARCH_CHUNK = 64  # queries per pq_adc scan: 256 MB of scores at n = 1M


class PQIndex(NamedTuple):
    codebooks: torch.Tensor   # (M, K, dsub) float32
    codes: torch.Tensor       # (n, M) uint8
    M: int
    K: int
    # OPQ rotation (d, d), orthogonal, or None for plain PQ: codebooks and
    # codes quantize ``base @ rotation``, and queries are rotated before the
    # LUT is built (the engine's ``scorer_state`` does)
    rotation: torch.Tensor | None = None


def _fold(seed: int, data: int) -> int:
    """A deterministic child seed of ``seed`` for ``data``."""
    return (seed * 0x9E3779B1 + 0x632BE5AB * (data + 1)) % (2**63 - 1)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _sq_dists(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(c, s) x (K, s) -> (c, K) squared distances in the reference's
    expanded form."""
    return ((x * x).sum(1)[:, None] - 2 * x @ cent.T
            + (cent * cent).sum(1)[None, :])


def _assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of every row (ties to the lowest index), int64."""
    return torch.cat([torch.argmin(_sq_dists(x[lo:lo + CHUNK], cent), dim=1)
                      for lo in range(0, x.shape[0], CHUNK)])


def _kmeans(seed: int, x: torch.Tensor, k: int, iters: int = 15,
            init: torch.Tensor | None = None) -> torch.Tensor:
    """Lloyd's k-means, (n, s) -> (k, s), from ``init`` (k, s) centroids or
    else k distinct random rows. Empty clusters re-seed from a random row,
    drawn per iteration from the same generator, so a retrain from the same
    seed walks the identical centroid trajectory."""
    n = x.shape[0]
    if k > n:
        raise ValueError(f"k-means needs k <= n, got k={k}, n={n}")
    g = _generator(x.device, seed)
    if init is None:
        cent = x[torch.randperm(n, generator=g, device=x.device)[:k]]
    elif init.shape != (k, x.shape[1]):
        raise ValueError(f"init must be ({k}, {x.shape[1]}), got {tuple(init.shape)}")
    else:
        cent = init.to(x)
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
        for lo in range(0, n, CHUNK):
            xc = x[lo:lo + CHUNK]
            onehot = torch.nn.functional.one_hot(
                torch.argmin(_sq_dists(xc, cent), dim=1), k).float()
            sums += onehot.T @ xc
            counts += onehot.sum(0)
        respawn = x[torch.randint(0, n, (k,), generator=g, device=x.device)]
        cent = torch.where(counts[:, None] > 0,
                           sums / torch.clamp(counts[:, None], min=1), respawn)
    return cent


def _train(seed: int, base: torch.Tensor, M: int, K: int, iters: int) -> torch.Tensor:
    """(M, K, dsub) codebooks, one k-means per sub-space, each from its own
    child seed."""
    n, d = base.shape
    dsub = d // M
    subs = base[:, :M * dsub].reshape(n, M, dsub)
    return torch.stack([_kmeans(_fold(seed, m), subs[:, m].contiguous(), K, iters)
                        for m in range(M)])


def _encode(base: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(n, d) against (M, K, dsub) codebooks -> (n, M) uint8 codes."""
    n = base.shape[0]
    M, K, dsub = codebooks.shape
    subs = base[:, :M * dsub].reshape(n, M, dsub)
    return torch.stack([_assign(subs[:, m], codebooks[m]) for m in range(M)],
                       dim=1).to(torch.uint8)


def derive_pq_key(seed: int) -> int:
    """The one seed derivation for scorer-backing PQ tables: the engine's
    lazy path (``Searcher.pq_index``) and the build's compress stage both
    train from it, so a build-time table equals a lazily trained one."""
    return _fold(seed, zlib.crc32(b"scorer:pq") & 0x7FFFFFFF)


def derive_opq_key(seed: int) -> int:
    """The seed derivation for build-time OPQ tables (``compress='opq'``),
    distinct from :func:`derive_pq_key`."""
    return _fold(seed, zlib.crc32(b"scorer:opq") & 0x7FFFFFFF)


def build_pq(base: torch.Tensor, M: int = 8, K: int = 256, iters: int = 15,
             key: int | None = None) -> PQIndex:
    """Train codebooks and encode ``base`` (n, d) on its device; ``key`` is
    an int seed (default 0)."""
    if base.shape[1] % M:
        raise ValueError(f"d must divide into M sub-vectors (d={base.shape[1]}, M={M})")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} codewords do not fit uint8 codes (1..{MAX_K})")
    base = base.float().contiguous()
    codebooks = _train(0 if key is None else key, base, M, K, iters)
    return PQIndex(codebooks=codebooks, codes=_encode(base, codebooks), M=M, K=K)


def reconstruct(index: PQIndex) -> torch.Tensor:
    """Decode codes back to vectors, (n, M*dsub) float32 — in the ROTATED
    space when ``index.rotation`` is set."""
    M = index.codebooks.shape[0]
    m = torch.arange(M, device=index.codes.device)
    rows = index.codebooks[m[None, :], index.codes.long()]   # (n, M, dsub)
    return rows.reshape(rows.shape[0], -1).float()


def build_opq(base: torch.Tensor, M: int = 8, K: int = 256, iters: int = 15,
              key: int | None = None, opq_iters: int = 6) -> PQIndex:
    """Optimized PQ [Ge CVPR'13]: alternate PQ training on ``base @ R`` with
    the closed-form orthogonal Procrustes update of R (SVD of
    ``base.T @ recon``). Deterministic for a fixed ``key``."""
    b = base.float().contiguous()
    d = b.shape[1]
    if d % M:
        raise ValueError(f"d must divide into M sub-vectors (d={d}, M={M})")
    R = torch.eye(d, dtype=torch.float32, device=b.device)
    for _ in range(opq_iters):
        recon = reconstruct(build_pq(b @ R, M=M, K=K, iters=iters, key=key))
        u, _, vt = torch.linalg.svd(b.T @ recon, full_matrices=False)
        R = u @ vt
    return build_pq(b @ R, M=M, K=K, iters=iters, key=key)._replace(rotation=R)


def build_adc_luts(queries: torch.Tensor, codebooks: torch.Tensor,
                   metric: str = "l2") -> torch.Tensor:
    """Per-query ADC lookup tables: (Q, d) x (M, K, dsub) -> (Q, M, K).

    l2 and ip are exact on the reconstruction; cos normalizes the query and
    scores by inner product against the un-normalized reconstruction,
    shifted by 1/M per entry (the reference's convention)."""
    M, K, dsub = codebooks.shape
    Q = queries.shape[0]
    q = queries[:, :M * dsub].float()
    if metric == "cos":
        q = q * torch.rsqrt(torch.clamp((q * q).sum(1, keepdim=True), min=1e-12))
    elif metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    sub_q = q.reshape(Q, M, dsub)
    cb = codebooks.float()
    cross = torch.einsum("qms,mks->qmk", sub_q, cb)
    if metric in ("ip", "cos"):
        return (1.0 / M if metric == "cos" else 0.0) - cross
    qq = (sub_q * sub_q).sum(2)[:, :, None]                   # (Q, M, 1)
    cc = (cb * cb).sum(2)[None, :, :]                         # (1, M, K)
    return qq - 2.0 * cross + cc


def pq_search(queries: torch.Tensor, base: torch.Tensor, index: PQIndex,
              k: int = 1, rerank: int = 64):
    """Returns (dists (Q, k), ids (Q, k), comps (Q,)).

    Queries go through the ``pq_adc`` scan ``SEARCH_CHUNK`` rows at a time
    in place of the reference's vmap; the ``rerank`` best ADC candidates of
    each are rescored exactly. comps counts full-d
    equivalents: the scan as n * M/d comparisons plus the rerank, as in the
    reference."""
    from ..kernels import ops

    Q, d = queries.shape
    n = base.shape[0]
    M = index.codebooks.shape[0]
    queries = queries.float().contiguous()
    luts = build_adc_luts(queries, index.codebooks).contiguous()   # (Q, M, K)
    dists, ids = [], []
    for lo in range(0, Q, SEARCH_CHUNK):
        q = queries[lo:lo + SEARCH_CHUNK]
        scores = ops.pq_adc(index.codes, luts[lo:lo + SEARCH_CHUNK])   # (c, n)
        _, cand = topk_smallest(scores, rerank)
        cand = cand.to(torch.int32)
        exact = ops.gather_distance(q, cand.contiguous(), base)
        dd, ii = topk_smallest(exact, k)
        dists.append(dd)
        ids.append(cand.gather(1, ii))
    comps = torch.full((Q,), int(n * M / d) + rerank, dtype=torch.int32,
                       device=queries.device)
    return torch.cat(dists), torch.cat(ids), comps
