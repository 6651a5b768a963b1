"""RecSys retrieval on the PyTorch port, end to end: embed -> filtered ANN
-> rerank, served. The counterpart of ``examples/recsys_retrieval.py``,
with the same flags, catalog and lines.

1. **Embed**: user histories are pooled into query embeddings with
   ``models.recsys.embedding_bag`` (mean); the items are the base matrix of
   an inner-product index (``core.engine.Searcher.build(metric="ip")``:
   NN-Descent + GD), with the metadata columns the filters read.
2. **Filtered ANN**: each request carries a ``core.filters.FilterSpec``. A
   broad recency-only filter walks the graph; a narrow per-tenant slice
   at or below ``engine.filtered_brute_cutoff`` is scanned exactly over
   its allowed ids. Requests go through the continuous-batching
   ``launch.server.AnnServer`` (buckets 1, 2, 4) and must equal direct
   search bit for bit.
3. **Rerank**: the ANN candidates are re-scored by exact inner product and
   cut to the final k; recall@k is against a brute-force oracle over the
   allowed items (``core.bruteforce.ground_truth``).

It asserts served == direct, no filter leak, and that a tenant with no
items gets all -1 ids and 0 comparisons.

    PYTHONPATH=src python examples/recsys_retrieval_torch.py                # one GPU
    PYTHONPATH=src python examples/recsys_retrieval_torch.py --device cpu --n 4000
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core.bruteforce import ground_truth  # noqa: E402
from repro_torch.core.engine import Searcher, filtered_brute_cutoff  # noqa: E402
from repro_torch.core.filters import FilterSpec  # noqa: E402
from repro_torch.launch.server import AnnServer, ServeConfig  # noqa: E402
from repro_torch.models.recsys import embedding_bag  # noqa: E402

RECENCY = 0.25   # only items with timestamp >= this are servable


def make_catalog(rng, n, dim, n_tenants):
    """Item embeddings (unit rows) plus the metadata columns the filters
    search over; the reference example's draws."""
    items = rng.standard_normal((n, dim)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    metadata = {
        "tenant": rng.integers(0, n_tenants, size=n).astype(np.int32),
        "timestamp": rng.random(n).astype(np.float32),
    }
    return items, metadata


def embed_users(table: torch.Tensor, histories) -> np.ndarray:
    """Pool each user's item history into one unit query embedding."""
    dev = table.device
    ids = torch.from_numpy(np.concatenate(histories)).to(dev)
    seg = torch.from_numpy(np.repeat(np.arange(len(histories)),
                                     [len(h) for h in histories])).to(dev)
    q = embedding_bag(table, ids, seg, num_segments=len(histories), mode="mean")
    return (q / torch.linalg.norm(q, dim=1, keepdim=True)).cpu().numpy()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="embed -> filtered ANN -> rerank through the live server")
    ap.add_argument("--n", type=int, default=20_000, help="catalog size")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--users", type=int, default=12)
    ap.add_argument("--hist", type=int, default=20, help="history length")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--k", type=int, default=10, help="final top-k")
    ap.add_argument("--ef", type=int, default=512)
    ap.add_argument("--k-retrieve", type=int, default=32,
                    help="ANN candidates fed to the exact reranker")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the catalog, the histories and the build")
    return ap


def main(argv=None) -> dict:
    """Run the example; returns its figures: n, build_s, requests (label,
    rows, servable items, path, mean comps, ms of its direct search with
    the device synchronised, latency_ms through the server from enqueue to
    completion), recall, server stats."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    items, metadata = make_catalog(rng, args.n, args.dim, args.tenants)
    table = torch.from_numpy(items).to(dev)

    # each user lives in one tenant; their history is items of that tenant
    user_tenant = np.arange(args.users) % args.tenants
    histories = [
        rng.choice(np.nonzero(metadata["tenant"] == t)[0], size=args.hist)
        for t in user_tenant
    ]
    queries = embed_users(table, histories)
    print(f"embedded {args.users} users from {args.hist}-item histories")

    t0 = time.perf_counter()
    searcher = Searcher.build(table, metric="ip", seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    searcher.metadata = metadata
    print(f"built ip index over {args.n} items in {build_s:.1f}s")

    spec = searcher.spec(ef=args.ef, k=args.k_retrieve)
    server = AnnServer(searcher, spec, ServeConfig(buckets=(1, 2, 4)))
    server.warmup(7)

    # mixed-filter request stream against ONE server + spec: a broad
    # recency-only filter (graph path) and one narrow per-tenant slice per
    # tenant (exact-scan fallback)
    recent = FilterSpec(time_range=(RECENCY, np.inf))
    reqs = [("recency", queries[:2], recent,
             server.submit_wait(queries[:2], 99, filter=recent))]
    for t in range(args.tenants):
        rows = queries[user_tenant == t]
        f = FilterSpec(tenant=int(t), time_range=(RECENCY, np.inf))
        reqs.append((t, rows, f, server.submit_wait(rows, 100 + t, filter=f)))
    server.drain()

    recalls, served = [], []
    for t, rows, f, req in reqs:
        # served vs direct: the bucketed path must be bit-identical
        t1 = time.perf_counter()
        direct = searcher.search(torch.from_numpy(rows).to(dev), spec._replace(filter=f),
                                 seed=req.seed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        direct_ms = (time.perf_counter() - t1) * 1e3
        assert np.array_equal(req.ids, direct.ids.cpu().numpy())
        assert np.array_equal(req.dists, direct.dists.cpu().numpy())

        allowed = metadata["timestamp"] >= RECENCY
        if f.tenant is not None:
            allowed &= metadata["tenant"] == f.tenant
        valid = req.ids >= 0
        assert np.all(allowed[req.ids[valid]]), "filter leak"

        # exact-ip rerank of the ANN candidates, cut to final k
        allowed_ids = np.nonzero(allowed)[0]
        allowed_items = torch.from_numpy(items[allowed]).to(dev)
        for row, cand in zip(rows, req.ids):
            cand = cand[cand >= 0]
            scores = items[cand] @ row
            final = cand[np.argsort(-scores)[:args.k]]
            oracle = ground_truth(torch.from_numpy(row[None]).to(dev), allowed_items,
                                  args.k, metric="ip")[0]
            oracle = allowed_ids[oracle.cpu().numpy()]
            recalls.append(len(set(final.tolist()) & set(oracle.tolist())) / args.k)
        path = ("exact-scan" if int(allowed.sum())
                <= filtered_brute_cutoff(spec) else "graph")
        label = t if f.tenant is None else f"tenant {t}"
        print(f"{label}: "
              f"{rows.shape[0]} queries, {int(allowed.sum())} servable "
              f"items [{path}], mean comps {float(req.n_comps.mean()):.0f}")
        served.append({"label": str(label), "rows": int(rows.shape[0]),
                       "servable": int(allowed.sum()), "path": path,
                       "mean_comps": float(req.n_comps.mean()),
                       "ms": direct_ms, "latency_ms": req.latency_s * 1e3})

    recall = float(np.mean(recalls))
    print(f"filtered recall@{args.k} after rerank: {recall:.3f}")

    # cold-start tenant: nothing matches -> all INVALID, zero comparisons
    empty = searcher.search(torch.from_numpy(queries[:1]).to(dev),
                            spec._replace(filter=FilterSpec(tenant=args.tenants + 1)),
                            seed=3)
    assert bool((empty.ids == -1).all())
    assert int(empty.n_comps.sum()) == 0
    print("cold-start tenant: empty result set, 0 comparisons")

    st = server.stats()
    print(f"server: {st['completed']} requests, versions swaps {st['swaps']}, "
          f"buckets {st['bucket_counts']}")
    return {"n": args.n, "build_s": build_s, "requests": served, "recall": recall,
            "stats": st}


if __name__ == "__main__":
    main()
