"""The rank body of the four-rank tests in ``tests/test_torch_distributed.py``.

A module of its own, importing neither jax nor repro, so that a spawned
rank imports only torch and the port. Rank r joins a gloo group through a
``FileStore``, runs ``distributed_search`` on its own shard for every case
of ``CASES``, and writes what it got to ``out_dir/rank{r}.npz``.
"""
import datetime

import numpy as np
import torch
import torch.distributed as dist

# (name, scorer, base placement, dead shard or -1)
CASES = (("exact", "exact", "device", -1), ("exact_dead2", "exact", "device", 2),
         ("pq", "pq", "device", -1), ("pq_dead0", "pq", "device", 0),
         ("pq_host", "pq", "host", -1), ("pq_host_dead0", "pq", "host", 0))
SEARCH = dict(ef=48, k=4)
COLLECTIVE_TIMEOUT_S = 60


def live_mask(P: int, dead: int) -> np.ndarray:
    live = np.ones((P,), bool)
    if dead >= 0:
        live[dead] = False
    return live


def run_rank(rank: int, world: int, store_path: str, inputs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.distributed.sharded_ann import distributed_search
    from repro_torch.launch.mesh import make_flat_group

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        fg = make_flat_group("cpu")
        assert (fg.rank, fg.size) == (rank, world)
        mine = slice(rank, rank + 1)

        def t(name, dtype=None):
            a = torch.from_numpy(np.ascontiguousarray(inputs[name][mine]))
            return a if dtype is None else a.to(dtype)

        queries = torch.from_numpy(inputs["queries"])
        out = {}
        for name, scorer, placement, dead in CASES:
            live = torch.from_numpy(live_mask(world, dead)[mine])
            kw = dict(SEARCH, group=fg.group, scorer=scorer, base_placement=placement)
            if scorer == "pq":
                kw.update(pq_codebooks=t("codebooks"), pq_codes=t("codes"))
            if placement != "device":
                kw["host_base"] = inputs["base"]
            d, i, c = distributed_search(
                queries, t("base_shards") if placement == "device" else None,
                t("nbr_shards"), t("entries"), live, **kw)
            out[f"{name}_dists"], out[f"{name}_ids"], out[f"{name}_comps"] = (
                d.numpy(), i.numpy(), c.numpy())
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
