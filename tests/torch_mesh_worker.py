"""The rank body of the sharded-step tests in ``tests/test_torch_mesh.py``.

A module of its own, importing neither jax nor repro, so that a spawned
rank imports only torch and the port. ``run_case`` takes ``STEPS`` train
steps of one case's smoke config through ``configs.common.cell_program`` on
a mesh, from the weights and batches it is given, and returns the losses
and every parameter gathered whole (``full_tensor``); ``run_train_lm`` does
the same through ``launch.train.train_lm`` from its own seed. ``run_rank``
joins a gloo group through a ``FileStore``, runs every case and
``run_train_lm`` on a (2, 2) mesh, and rank 0 writes what it got to
``out_dir/rank0.npz``.
"""
import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

STEPS = 2
B, S = 4, 16
# name -> (arch, parallel_mode, extra)
CASES = {"tinyllama": ("tinyllama-1.1b", "tp", {}),
         "gemma3": ("gemma3-12b", "tp", {}),
         "deepseek_dp": ("deepseek-v3-671b", "dp", {}),
         "deepseek_mla": ("deepseek-v3-671b", "tp", {"mla_replicated_latents": True})}
# the launcher's own path: TinyLlama's smoke config, STEPS steps of B x S
TRAIN_LM_ARGV = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", str(STEPS), "--batch",
                 str(B), "--seq", str(S), "--device", "cpu"]
COLLECTIVE_TIMEOUT_S = 60


def run_case(mesh, name: str, tree: dict, batches: list) -> dict:
    """-> {"loss": (STEPS,), "p:<name>": each parameter after the steps}."""
    from repro_torch import configs
    from repro_torch.configs import common
    from repro_torch.distributed import sharding
    from repro_torch.models import convert
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_loop import trainable

    arch, mode, extra = CASES[name]
    ad = configs.get_arch(arch)
    ad = dataclasses.replace(ad, model_cfg=ad.smoke_cfg, parallel_mode=mode, extra=extra)
    prog = common.cell_program(ad, "train_4k", mesh)
    model = convert.lm_params_from_numpy(tree, prog.args[0].cfg, "cpu")
    opt_state = make_optimizer(ad.optimizer)[0](trainable(model))
    model, opt_state, _ = common.shard_args(prog, (model, opt_state, prog.args[2]), mesh)
    losses = []
    for nb in batches:
        batch = sharding.shard_tree({k: torch.from_numpy(v) for k, v in nb.items()},
                                    prog.specs[2], mesh)
        opt_state, loss = prog.step(model, opt_state, batch)
        losses.append(float(loss.full_tensor()))
    out = {"loss": np.array(losses)}
    for n, p in model.named_parameters():
        out[f"p:{n}"] = p.detach().full_tensor().numpy()
    return out


def run_train_lm(mesh) -> dict:
    """``launch.train.train_lm`` (the CLI's body) on ``mesh`` at
    ``TRAIN_LM_ARGV``: -> {"loss": the logged losses, "p:<name>": each
    parameter after the steps}."""
    from repro_torch.launch import train

    res = train.train_lm(train.parser().parse_args(TRAIN_LM_ARGV), mesh)
    out = {"loss": np.array([loss for _, loss in res["history"]])}
    for n, p in res["params"].named_parameters():
        out[f"p:{n}"] = p.detach().full_tensor().numpy()
    return out


def run_rank(rank: int, world: int, store_path: str, inputs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_test_mesh((2, 2), device_type="cpu")
        got = {}
        for name in CASES:
            res = run_case(mesh, name, inputs[name]["tree"], inputs[name]["batches"])
            got.update({f"{name}/{k}": v for k, v in res.items()})
        got.update({f"train_lm/{k}": v for k, v in run_train_lm(mesh).items()})
        if rank == 0:
            np.savez(f"{out_dir}/rank0.npz", **got)
    finally:
        dist.destroy_process_group()
