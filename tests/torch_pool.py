"""Shared inputs for the tests of the NN-Descent scoring pass
(``ops.gather_distance_pool``), on the CPU and on the card."""
import numpy as np
import torch


def pool_world(n, C, d, seed=0):
    """base (n, d) and an (n, C) pool: INVALID ids, an all-INVALID row,
    ids repeated within a row and one id past the base (read as row n-1)."""
    rng = np.random.default_rng(seed + n + C + d)
    base = rng.standard_normal((n, d), dtype=np.float32)
    pool = rng.integers(-1, n, size=(n, C)).astype(np.int32)
    if C > 1:
        pool[:, ::7] = -1
    pool[0, -1] = n - 1
    if n > 6:
        pool[3] = -1
        pool[5, : C // 2] = pool[5, C // 2: 2 * (C // 2)]
        pool[6, -1] = n + 5
    return base, pool


def chunked_pass(gather, base, pool, metric, chunk=1024):
    """The scoring pass as a gather of ``chunk`` rows a step, the rows' own
    base rows as queries: ``gather(queries, ids, base, metric)``, the
    generic gather kernel or its plain version."""
    return torch.cat([gather(base[lo:lo + chunk], pool[lo:lo + chunk].contiguous(), base,
                             metric)
                      for lo in range(0, base.shape[0], chunk)])
