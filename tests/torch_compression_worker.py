"""The rank body of the two-rank test in ``tests/test_torch_compression.py``.

A module of its own, importing neither jax nor repro, so that a spawned
rank imports only torch and the port. Rank r joins a gloo group through a
``FileStore``, reduces its row of ``xs`` with its row of ``noises`` through
``compressed_psum_int8``, and writes the result to ``out_dir/rank{r}.npy``.
"""
import datetime

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 30


def run_rank(rank: int, world: int, store_path: str, xs, noises, out_dir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.distributed.compression import compressed_psum_int8

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = compressed_psum_int8(torch.from_numpy(xs[rank]), torch.from_numpy(noises[rank]))
        np.save(f"{out_dir}/rank{rank}.npy", out.numpy())
    finally:
        dist.destroy_process_group()
