"""Open-loop Poisson load generator for the port's ANN server, as the
reference's ``benchmarks/loadgen.py``.

An open loop draws arrival times from a seeded Poisson process and submits
on schedule whether or not earlier requests finished: offered load is an
input, latency and shed rate are outputs. Everything is deterministic per
seed: request sizes and pool offsets come from one
``np.random.default_rng`` (the reference's draws, so sizes, starts and
arrivals equal its own), and request i's seed is ``_fold(base_seed, i)``, so
every served request can be held bit for bit against a direct
``Searcher.search`` of its rows with its seed.

    PYTHONPATH=src python -m repro_torch.launch.loadgen --mode closed --device cpu

runs the serving smoke: a closed loop over a small world (n=3,000, d=16)
that exits nonzero unless every served request equals its direct search.
``--mode open`` offers 0.5x the measured capacity (or ``--qps``);
``--mode mutation`` runs one index lifecycle under live traffic (serve,
insert and delete through ``MutableIndex``, hot-swap, serve again,
compact). The world is uniform, made with numpy from ``--seed``.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import bruteforce, diversify
from ..core.engine import Searcher, SearchSpec, _fold
from .server import AnnServer, ServeConfig, _sync, prepared_state

# Offered load as a fraction of measured closed-batch (serial) capacity
# (the reference's sweep points).
LOAD_FACTORS = (0.05, 0.5, 3.0)
# not all bucket sizes: 3 pads to 4 and 6 pads to 8, so mean_fill measures
# padding overhead
REQUEST_SIZES = (1, 2, 3, 4, 6, 8)

SWEEP_CONFIG = ServeConfig(buckets=(1, 2, 4, 8, 16),
                           max_live_batches=4, max_queue_depth=16)


class RequestSpec(NamedTuple):
    """One request to be offered: real query rows, its seed, and where its
    rows sit in the pool (for ground-truth lookup)."""

    rows: np.ndarray
    seed: int
    start: int


def poisson_arrivals(qps: float, n: int, seed: int) -> np.ndarray:
    """n arrival times (seconds from t0) of a Poisson process with the given
    request rate: exponential inter-arrivals, deterministic per seed."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


def make_requests(pool: np.ndarray, n_requests: int, sizes, seed: int,
                  base_seed: int) -> list[RequestSpec]:
    """Ragged request stream over a query pool: sizes drawn uniformly from
    ``sizes``, rows sliced at seeded offsets (no wraparound), request i
    seeded with ``_fold(base_seed, i)``."""
    rng = np.random.default_rng(seed)
    pool = np.asarray(pool, np.float32)
    reqs = []
    for i in range(n_requests):
        sz = int(rng.choice(sizes))
        start = int(rng.integers(0, pool.shape[0] - sz + 1))
        reqs.append(RequestSpec(rows=pool[start:start + sz], seed=_fold(base_seed, i),
                                start=start))
    return reqs


def run_open_loop(server: AnnServer, requests: list[RequestSpec],
                  arrivals: np.ndarray) -> None:
    """Submit each request at its scheduled arrival regardless of
    completions, polling the server while waiting; blocks until drained."""
    t0 = time.monotonic()
    for req, at in zip(requests, arrivals):
        while True:
            dt = at - (time.monotonic() - t0)
            if dt <= 0:
                break
            server.poll()
            time.sleep(min(dt, 5e-4))
        # more than 1 ms behind schedule: enqueue or shed only (the listener
        # half of a server), so the queue can fill and the shed path run
        server.submit(req.rows, req.seed, advance=dt > -1e-3)
    server.drain()


def run_closed_loop(server: AnnServer, requests: list[RequestSpec]) -> None:
    """Backpressured stream: a full queue blocks the client, never sheds."""
    for req in requests:
        server.submit_wait(req.rows, req.seed)
    server.drain()


def _direct(searcher: Searcher, spec: SearchSpec, req: RequestSpec):
    return searcher.search(torch.from_numpy(req.rows).to(searcher.device), spec, req.seed)


def direct_baseline(searcher: Searcher, spec: SearchSpec,
                    requests: list[RequestSpec]):
    """Every request straight through ``Searcher.search`` with its own seed:
    (numpy (ids, dists, n_comps) per request, timed walls of a second pass
    with the device synchronised after each request)."""
    results = []
    for req in requests:
        res = _direct(searcher, spec, req)
        results.append((res.ids.cpu().numpy(), res.dists.cpu().numpy(),
                        res.n_comps.cpu().numpy()))
    walls = []
    for req in requests:
        t = time.monotonic()
        _direct(searcher, spec, req)
        _sync(searcher.device)
        walls.append(time.monotonic() - t)
    return results, np.array(walls)


def paced_direct_walls(searcher: Searcher, spec: SearchSpec,
                       requests: list[RequestSpec],
                       arrivals: np.ndarray) -> np.ndarray:
    """Single-request search walls on the low-load point's arrival schedule:
    each request sleeps until its arrival, then one synchronised direct
    search (the same idle gaps the server sees)."""
    walls = []
    t0 = time.monotonic()
    for req, at in zip(requests, arrivals):
        dt = at - (time.monotonic() - t0)
        if dt > 0:
            time.sleep(dt)
        t = time.monotonic()
        _direct(searcher, spec, req)
        _sync(searcher.device)
        walls.append(time.monotonic() - t)
    return np.array(walls)


def check_parity(completed, baseline: dict) -> tuple[int, int]:
    """(matched, checked) over ids/dists/n_comps of every completed request
    against its direct-search twin."""
    ok = 0
    for req in completed:
        ids, dists, comps = baseline[req.rid]
        if (np.array_equal(req.ids, ids)
                and np.array_equal(req.dists, dists)
                and np.array_equal(req.n_comps, comps)):
            ok += 1
    return ok, len(completed)


def _recall_comps(reqs_done, requests: list[RequestSpec],
                  gt: np.ndarray) -> tuple[float, float]:
    hits, rows, comps = 0, 0, 0.0
    for req in reqs_done:
        spec_ = requests[req.rid]
        g = gt[spec_.start:spec_.start + req.ids.shape[0], 0]
        hits += int((req.ids[:, 0] == g).sum())
        rows += req.ids.shape[0]
        comps += float(req.n_comps.sum())
    return hits / max(rows, 1), comps / max(rows, 1)


def serving_sweep(searcher: Searcher, spec: SearchSpec, pool, gt,
                  load_factors=LOAD_FACTORS, n_requests: int = 120,
                  sizes=REQUEST_SIZES, config: ServeConfig = SWEEP_CONFIG,
                  seed: int = 0, out=print) -> dict:
    """Offered-QPS sweep: measure closed-batch capacity, then run the same
    request stream open-loop at each load factor. Returns
    {"serving_ref_wall_ms", "serving_capacity_qps", "serving_batch_recall_at_1",
    "serving_batch_comps_per_query", "serving_sweep": [row per load factor]};
    writes no file."""
    pool = np.asarray(pool, np.float32)
    gt = np.asarray(gt)
    base_seed = _fold(searcher.rng_seed, 777)
    requests = make_requests(pool, n_requests, sizes, seed, base_seed)

    direct, walls = direct_baseline(searcher, spec, requests)
    baseline = dict(enumerate(direct))
    total_rows = sum(r.rows.shape[0] for r in requests)
    capacity_qps = total_rows / float(walls.sum())
    mean_size = total_rows / n_requests
    # single-request walls paced at the first (lowest) load point's schedule
    low_arrivals = poisson_arrivals(
        load_factors[0] * capacity_qps / mean_size, n_requests, seed * 1000
    )
    paced = paced_direct_walls(searcher, spec, requests, low_arrivals)
    ref_wall_ms = float(np.percentile(paced, 99)) * 1e3
    out(f"loadgen/baseline: capacity={capacity_qps:.1f} rows/s "
        f"(hot back-to-back), paced single-request wall "
        f"p50={float(np.percentile(paced, 50)) * 1e3:.2f}ms "
        f"p99={ref_wall_ms:.2f}ms over {n_requests} requests "
        f"({total_rows} rows)")

    rows = []
    for li, lf in enumerate(load_factors):
        offered_qps = lf * capacity_qps
        arrivals = poisson_arrivals(offered_qps / mean_size, n_requests,
                                    seed=seed * 1000 + li)
        server = AnnServer(searcher, spec, config)
        server.warmup()
        run_open_loop(server, requests, arrivals)
        st = server.stats()
        ok, checked = check_parity(server.completed, baseline)
        recall, comps = _recall_comps(server.completed, requests, gt)
        ordered = all(r.t_enqueue <= r.t_admit <= r.t_dispatch <= r.t_complete
                      for r in server.completed)
        service = [r.t_complete - r.t_admit for r in server.completed]
        row = {
            "load_factor": lf,
            "offered_qps": round(offered_qps, 1),
            "n_requests": n_requests,
            "completed": st["completed"],
            "shed": st["shed"],
            "shed_rate": round(st["shed"] / n_requests, 4),
            "p50_ms": st.get("p50_ms"),
            "p90_ms": st.get("p90_ms"),
            "p99_ms": st.get("p99_ms"),
            "mean_queue_ms": st.get("mean_queue_ms"),
            "mean_service_ms": round(float(np.mean(service)) * 1e3, 3) if service else None,
            "sustained_qps": st.get("sustained_qps"),
            "parity": round(ok / max(checked, 1), 4),
            "recall_at_1": round(recall, 4),
            "comps_per_query": round(comps, 1),
            "mean_fill": st["mean_fill"],
            "bucket_counts": st["bucket_counts"],
            "max_live": st["max_live"],
            "timestamps_ordered": ordered,
        }
        rows.append(row)
        out(f"loadgen/sweep x{lf}: offered={row['offered_qps']:.1f} "
            f"p50={row['p50_ms']}ms p90={row['p90_ms']}ms p99={row['p99_ms']}ms "
            f"queue={row['mean_queue_ms']}ms service={row['mean_service_ms']}ms "
            f"sustained={row['sustained_qps']} "
            f"shed={row['shed']} parity={row['parity']:.3f} fill={row['mean_fill']:.2f} "
            f"buckets={row['bucket_counts']} max_live={row['max_live']}")
    b_recall, b_comps = _batch_twins(requests, baseline, gt)
    return {
        "serving_ref_wall_ms": round(ref_wall_ms, 3),
        "serving_capacity_qps": round(capacity_qps, 1),
        "serving_batch_recall_at_1": round(b_recall, 4),
        "serving_batch_comps_per_query": round(b_comps, 1),
        "serving_sweep": rows,
    }


def _batch_twins(requests, baseline, gt) -> tuple[float, float]:
    hits, rows, comps = 0, 0, 0.0
    for i, spec_ in enumerate(requests):
        ids, _, n_comps = baseline[i]
        g = gt[spec_.start:spec_.start + ids.shape[0], 0]
        hits += int((ids[:, 0] == g).sum())
        rows += ids.shape[0]
        comps += float(n_comps.sum())
    return hits / max(rows, 1), comps / max(rows, 1)


def _uniform(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _build_world(n: int, d: int, pool_q: int, seed: int, device: torch.device):
    """Uniform (n, d) base and (pool_q, d) pool from ``seed``, the exact
    16-NN graph pruned by GD, and the pool's ground truth."""
    base = torch.from_numpy(_uniform(seed, (n, d))).to(device)
    pool = _uniform(_fold(seed, 1), (pool_q, d))
    g = bruteforce.exact_knn_graph(base, 16)
    gd = diversify.build_gd_graph(base, g)
    searcher = Searcher.from_graph(base, gd, rng_seed=seed)
    gt = bruteforce.ground_truth(torch.from_numpy(pool).to(device), base, 1).cpu().numpy()
    return searcher, pool, gt


def mutation_cycle(args) -> None:
    """``--mode mutation``: one index lifecycle under live traffic. Build
    v0, serve a closed loop, insert and delete through ``MutableIndex``,
    hot-swap the mutated index into the same server, serve a second closed
    loop, then compact and hold the compacted graph against a fresh build of
    the survivors. Gates (exit 1 on any failure): every served request on
    both sides of the swap equals a direct search on the version that
    served it; nothing shed; nothing built or loaded after the flip
    (``prepared_state``); no tombstoned id in any answer; compact == fresh
    build, bit for bit."""
    from ..core.build import BuildSpec, build_index
    from ..core.mutable import MutableIndex

    device = resolve_device(args.device)
    n, d = args.n, args.d
    base = _uniform(args.seed, (n, d))
    pool = _uniform(_fold(args.seed, 1), (args.pool_q, d))
    bspec = BuildSpec(construct="nndescent", diversify="gd", graph_k=16,
                      proxy_sample=0, lid_sample=0, insert_ef=32)
    result = build_index(torch.from_numpy(base).to(device), bspec, seed=args.seed)
    midx = MutableIndex.from_build(torch.from_numpy(base).to(device), result,
                                   metric=bspec.metric, rng_seed=args.seed,
                                   insert_ef=32, diversify="gd")
    spec = SearchSpec(ef=args.ef, k=1, entry="random", term=args.term,
                      stable_steps=args.stable_steps, restarts=args.restarts)

    half = max(args.requests // 2, 1)
    base_seed = _fold(args.seed, 777)
    reqs_a = make_requests(pool, half, REQUEST_SIZES, args.seed, base_seed)
    reqs_b = make_requests(pool, half, REQUEST_SIZES, args.seed + 1, _fold(base_seed, 1))

    # phase A: serve the freshly built v0
    s0 = midx.searcher()
    server = AnnServer(s0, spec, SWEEP_CONFIG)
    server.warmup()
    direct_a, _ = direct_baseline(s0, spec, reqs_a)
    run_closed_loop(server, reqs_a)
    ok_a, checked_a = check_parity(server.completed, dict(enumerate(direct_a)))

    # mutate: insert a wave, tombstone 15%
    n_ins = max(n // 10, 8)
    extra = _uniform(_fold(args.seed, 5), (n_ins, d))
    new_ids = midx.insert_batch(extra)
    rng = np.random.default_rng(args.seed)
    dead = rng.choice(n, size=max(int(0.15 * n), 1), replace=False)
    midx.delete(dead)
    mstats = midx.stats()

    # hot swap to the mutated index, serve phase B
    s1 = midx.searcher()
    direct_b, _ = direct_baseline(s1, spec, reqs_b)
    version = server.swap(s1, seed=_fold(args.seed, 33))
    state_at_flip = prepared_state(s1)
    run_closed_loop(server, reqs_b)
    state_after = prepared_state(s1)
    done_b = server.completed[checked_a:]
    ok_b, checked_b = check_parity(done_b, {half + i: r for i, r in enumerate(direct_b)})
    dead_set = set(int(i) for i in dead)
    dead_hits = sum(int(i) in dead_set for req in done_b for i in req.ids.ravel())

    # merge-compact, bit-check against a fresh build
    cseed = _fold(args.seed, 9)
    survivors = midx.base[midx.alive]
    cres = midx.compact(bspec, cseed)
    fresh = build_index(torch.from_numpy(survivors).to(device), bspec, seed=cseed)
    fresh_nbrs = fresh.graph.neighbors.cpu().numpy()
    compact_ok = (np.array_equal(cres.graph.neighbors.cpu().numpy(), fresh_nbrs)
                  and np.array_equal(midx.neighbors, fresh_nbrs))
    gt = bruteforce.ground_truth(torch.from_numpy(pool).to(device),
                                 torch.from_numpy(midx.base).to(device), 1,
                                 midx.metric).cpu().numpy()
    res = midx.search(torch.from_numpy(pool).to(device), spec, _fold(args.seed, 12))
    recall = float((res.ids[:, 0].cpu().numpy() == gt[:, 0]).mean())

    st = server.stats()
    print(f"loadgen/mutation: v{version} served {st['completed']} requests "
          f"({st['shed']} shed) across 1 swap; parity A={ok_a}/{checked_a} "
          f"B={ok_b}/{checked_b}, dead-id answers={dead_hits}")
    print(f"loadgen/mutation: inserted {len(new_ids)} "
          f"({mstats['insert_rate']:.0f} pts/s), deleted {len(dead)}, "
          f"staleness={mstats['staleness']:.3f}; post-compact "
          f"recall@1={recall:.3f}, compact==fresh-build: {compact_ok}")
    failures = []
    if st["shed"]:
        failures.append(f"{st['shed']} requests shed")
    if ok_a != checked_a or checked_a != half:
        failures.append(f"phase-A parity {ok_a}/{checked_a} (want {half})")
    if ok_b != checked_b or checked_b != half:
        failures.append(f"phase-B parity {ok_b}/{checked_b} (want {half})")
    if dead_hits:
        failures.append(f"{dead_hits} tombstoned ids served as answers")
    if state_after != state_at_flip:
        failures.append(f"state built or loaded after the flip ({state_at_flip} -> "
                        f"{state_after})")
    if not compact_ok:
        failures.append("compacted graph diverges from fresh build")
    if failures:
        print("loadgen/mutation: FAIL — " + "; ".join(failures))
        raise SystemExit(1)
    print("loadgen/mutation: OK — zero drops across the swap, bit-parity "
          "both sides, nothing built or loaded after the flip, compact bit-matches")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("open", "closed", "mutation"), default="closed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--pool-q", type=int, default=256)
    ap.add_argument("--ef", type=int, default=32)
    ap.add_argument("--term", choices=("fixed", "stable"), default="fixed",
                    help="per-query termination mode under test")
    ap.add_argument("--stable-steps", type=int, default=8)
    ap.add_argument("--restarts", type=int, default=0,
                    help="fresh-seed restarts per query (the per-row restart-key "
                         "parity path)")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open mode: offered request rate (0 = 0.5x measured capacity)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.mode == "mutation":
        mutation_cycle(args)
        return

    device = resolve_device(args.device)
    searcher, pool, gt = _build_world(args.n, args.d, args.pool_q, args.seed, device)
    spec = SearchSpec(ef=args.ef, k=1, entry="random", term=args.term,
                      stable_steps=args.stable_steps, restarts=args.restarts)
    requests = make_requests(pool, args.requests, REQUEST_SIZES, args.seed,
                             _fold(searcher.rng_seed, 777))
    direct, walls = direct_baseline(searcher, spec, requests)
    baseline = dict(enumerate(direct))

    server = AnnServer(searcher, spec, SWEEP_CONFIG)
    server.warmup()
    if args.mode == "closed":
        run_closed_loop(server, requests)
    else:
        total_rows = sum(r.rows.shape[0] for r in requests)
        cap = total_rows / float(walls.sum())
        req_rate = args.qps or 0.5 * cap / (total_rows / args.requests)
        run_open_loop(server, requests,
                      poisson_arrivals(req_rate, args.requests, args.seed))
    st = server.stats()
    ok, checked = check_parity(server.completed, baseline)
    recall, comps = _recall_comps(server.completed, requests, gt)
    print(f"loadgen/{args.mode}: completed={st['completed']} "
          f"shed={st['shed']} p50={st.get('p50_ms')}ms "
          f"p99={st.get('p99_ms')}ms sustained={st.get('sustained_qps')} "
          f"parity={ok}/{checked} recall@1={recall:.3f} comps={comps:.0f} "
          f"fill={st['mean_fill']:.2f} buckets={st['bucket_counts']} "
          f"max_live={st['max_live']}")
    if args.mode == "closed" and (st["shed"] or checked != args.requests):
        print("loadgen: FAIL — closed loop must complete every request")
        raise SystemExit(1)
    if ok != checked:
        print(f"loadgen: FAIL — {checked - ok} served requests diverge from "
              f"direct Searcher.search")
        raise SystemExit(1)
    print("loadgen: OK — every served request bit-matches direct search")


if __name__ == "__main__":
    main()
