"""Quickstart on the PyTorch port, the counterpart of
``examples/quickstart.py`` with its flags, defaults, lines and asserts: one
BuildSpec builds the paper's hybrid index through the unified pipeline
(construct · diversify · compress), persists it as an IndexArtifact, and
searches it through the Searcher: one beam core, pluggable entry
strategies including the build-derived hub shortlist, and per-query
adaptive termination (DESIGN.md §3, §10, §12).

    PYTHONPATH=src python examples/quickstart_torch.py                # one GPU
    PYTHONPATH=src python examples/quickstart_torch.py --serve
    PYTHONPATH=src python examples/quickstart_torch.py --ladder
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --scale 0.005

``--serve`` runs the continuous-batching server (``launch/server.py``,
DESIGN.md §11) instead of closed batches: ragged requests arrive open-loop
on a Poisson schedule (``launch/loadgen.py``), pad into bucketed cores, and
every answer still bit-matches direct search. ``--ladder`` walks the
quantization ladder (exact / sq8 / pq bytes-per-vertex) and reranks from
an mmap'd sharded artifact: the disk tier (DESIGN.md §15). Every
assertion of the reference is held: served == direct, disk == host rerank
and the artifact round trip, each bit for bit.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import bruteforce  # noqa: E402
from repro_torch.core import io as index_io  # noqa: E402
from repro_torch.core.build import BuildSpec, GraphBuilder  # noqa: E402
from repro_torch.core.engine import Searcher, SearchSpec, _fold  # noqa: E402
from repro_torch.data.synthetic import make_ann_dataset  # noqa: E402

SEED = 0


def serve_demo(searcher, queries, metric):
    """Open-loop serving over the built index: offered QPS in, p50/p99 and
    shed rate out (DESIGN.md §11)."""
    from repro_torch.launch.loadgen import make_requests, poisson_arrivals, run_open_loop
    from repro_torch.launch.server import AnnServer, ServeConfig

    spec = SearchSpec(ef=32, k=1, metric=metric, entry="random")
    server = AnnServer(searcher, spec,
                       ServeConfig(buckets=(1, 2, 4, 8, 16), max_live_batches=4,
                                   max_queue_depth=16))
    server.warmup()    # one core per bucket, off the clock

    pool = queries.cpu().numpy().astype(np.float32)
    requests = make_requests(pool, n_requests=150, sizes=(1, 2, 4, 8), seed=0,
                             base_seed=_fold(searcher.rng_seed, 777))
    mean_size = sum(r.rows.shape[0] for r in requests) / len(requests)
    for qps in (100.0, 400.0):
        srv = AnnServer(server.searcher, spec, server.config)
        srv.warmup()
        run_open_loop(srv, requests, poisson_arrivals(qps / mean_size, len(requests), seed=1))
        st = srv.stats()
        print(f"serve @ {qps:>5.0f} offered qps: p50={st['p50_ms']}ms "
              f"p90={st['p90_ms']}ms p99={st['p99_ms']}ms "
              f"sustained={st['sustained_qps']} shed={st['shed']} "
              f"fill={st['mean_fill']} buckets={st['bucket_counts']}")
    # the §11 contract: a served request == direct search, bit for bit
    req = srv.completed[0]
    direct = srv.searcher.search(torch.from_numpy(req.queries).to(searcher.device), spec,
                                 req.seed)
    assert (req.ids == direct.ids[:req.ids.shape[0]].cpu().numpy()).all()
    print("served answers bit-match direct Searcher.search: True")


def ladder_demo(searcher, base, queries, metric):
    """The quantization ladder and the disk tier (DESIGN.md §15): three
    scored representations at 4d / d / M bytes per visited vertex, then a
    sharded bf16 artifact reranked from mmap'd shards, bit-identical to the
    host tier."""
    from repro_torch.core.base_store import BaseStore

    gt = bruteforce.ground_truth(queries, base, 1, metric)
    ladder = SearchSpec(ef=48, k=1, metric=metric, entry="projection")
    for scorer in ("exact", "sq8", "pq"):
        res = searcher.search(queries, ladder._replace(scorer=scorer))
        recall = float((res.ids[:, 0] == gt[:, 0]).float().mean())
        bpq = float(torch.as_tensor(res.bytes_touched).float().mean())
        print(f"scorer {scorer:5s}: recall@1={recall:.3f}  "
              f"scored+rerank bytes/query={bpq:,.0f}")

    # persist with a sharded bf16 base, mmap the shards back, and rerank the
    # sq8 traversal from disk: ids must match the host tier exactly
    with tempfile.TemporaryDirectory() as td:
        path = index_io.save_index(os.path.join(td, "ladder_index"),
                                   index_io.IndexArtifact.from_searcher(searcher),
                                   shard_rows=4096, shard_dtype="bf16")
        s2 = index_io.load_index(path).to_searcher(searcher.device)
        shards, dt = index_io.open_base_shards(path)
        s2.attach_store(BaseStore.from_shards(shards, dt, device=searcher.device))
        dspec = ladder._replace(scorer="sq8", base_placement="disk", store_dtype=dt)
        dev = s2.search(queries, dspec._replace(base_placement="device", store_dtype="f32"))
        dsk = s2.search(queries, dspec)
        # the §15 contract, asserted: same store dtype -> host and disk
        # rerank the same survivors through the same formula, bit for bit
        hst = s2.search(queries, dspec._replace(base_placement="host"))
        assert bool((hst.ids == dsk.ids).all())
        assert bool((hst.dists == dsk.dists).all())
        print(f"disk tier ({len(shards)} bf16 shards): "
              f"bit-identical to host rerank=True, ids match f32 device="
              f"{bool((dev.ids == dsk.ids).all())}  "
              f"bytes/query={float(torch.as_tensor(dsk.bytes_touched).float().mean()):,.0f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true",
                    help="open-loop continuous-batching serving demo (§11)")
    ap.add_argument("--ladder", action="store_true",
                    help="quantization ladder + disk tier demo (§15)")
    ap.add_argument("--scale", type=float, default=0.02,
                    help="fraction of SIFT1M to synthesize (CI uses 0.005)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    base, queries, metric = make_ann_dataset("SIFT1M", scale=args.scale, n_queries=200,
                                             device=dev)
    print(f"dataset: n={base.shape[0]} d={base.shape[1]} metric={metric}")

    # 1. one spec = the whole build: NN-Descent (KGraph) -> GD diversification
    #    (the paper's hybrid scheme) -> no compression. Swap any stage by
    #    name: construct="exact"|"hnsw", diversify="dpg"|"none",
    #    compress="pq".
    spec = BuildSpec(construct="nndescent", diversify="gd", metric=metric, graph_k=20)
    result = GraphBuilder(spec).build(base, seed=SEED)
    rep = result.report
    print(f"built {spec.construct}·{spec.diversify}·{spec.compress} in "
          f"{rep.wall_total_s:.1f}s: {rep.rounds} NN-Descent rounds "
          f"(update curve {list(rep.update_curve)}), "
          f"graph-recall proxy {rep.graph_recall_proxy:.3f}, "
          f"degree mean {rep.degree['mean']} max {rep.degree['max']}, "
          f"{rep.dropped_reverse_edges} reverse edges dropped, "
          f"{rep.memory_bytes / 2**20:.1f} MiB")

    # 2. bind it to the engine and search: swappable seeding through the one
    #    beam core: random (the paper's flat-HNSW start) vs projection
    #    (SRS-style sketch scan) vs hubs (top in-degree shortlist from the
    #    build, DESIGN.md §12)
    searcher = Searcher.from_build(base, result, rng_seed=SEED)
    if args.serve:
        serve_demo(searcher, queries, metric)
        return
    if args.ladder:
        ladder_demo(searcher, base, queries, metric)
        return
    gt = bruteforce.ground_truth(queries, base, 1, metric)
    for entry in ("random", "projection", "hubs"):
        for ef in (16, 32, 64):
            sspec = SearchSpec(ef=ef, k=1, metric=metric, entry=entry)
            res = searcher.search(queries, sspec)
            recall = float((res.ids[:, 0] == gt[:, 0]).float().mean())
            comps = float(res.n_comps.float().mean())
            print(f"{entry:10s} ef={ef:3d}: recall@1={recall:.3f}  "
                  f"comps/query={comps:.0f} (exhaustive={base.shape[0]}, "
                  f"speedup={base.shape[0] / comps:.1f}x)")

    # 2b. adaptive termination (§12): fixed budget vs per-query stability
    #     freeze at a raised ef ceiling; restarts resurrect badly-converged rows
    fixed = SearchSpec(ef=32, k=1, metric=metric, entry="hubs")
    for label, sspec in (
        ("fixed ef=32", fixed),
        ("stable ef=64 s=12", fixed._replace(ef=64, term="stable", stable_steps=12)),
        ("stable + 2 restarts",
         fixed._replace(ef=64, term="stable", stable_steps=12, restarts=2)),
    ):
        res = searcher.search(queries, sspec, SEED)
        recall = float((res.ids[:, 0] == gt[:, 0]).float().mean())
        comps = float(res.n_comps.float().mean())
        print(f"term {label:20s}: recall@1={recall:.3f}  comps/query={comps:.0f}")

    # 3. persist + reload: the artifact round-trips the graph, metric, key
    #    and build provenance; a reloaded index answers bit-identically
    with tempfile.TemporaryDirectory() as td:
        path = index_io.save_index(
            os.path.join(td, "quickstart_index"),
            index_io.IndexArtifact.from_build(base, result, metric=metric, rng_seed=SEED))
        art = index_io.load_index(path)
        sspec = SearchSpec(ef=32, k=1, metric=metric, entry="projection")
        a = searcher.search(queries, sspec)
        b = art.to_searcher(dev).search(queries, sspec)
        match = bool((a.ids == b.ids).all())
        assert match
        built_by = art.provenance["build_report"]["spec"]["construct"]
        print(f"artifact round-trip via {os.path.basename(path)}: "
              f"bit-identical={match} (built by: {built_by})")


if __name__ == "__main__":
    main()
