"""Optimizers, the train step, checkpoints, restarts and the training CLI of
the port, the counterparts of ``tests/test_train_infra.py``, on the CPU.

The optimizers run against the reference's on one numpy tree (1-D, 2-D
and 3-D leaves) for five steps: fp32 parameters within 1e-6 relative (the
same expressions in another framework), bf16 parameters within one bf16
ulp (a fp32 update that differs in its last bits can round to the
neighbouring bf16 value). ``fit`` and ``run_with_restarts`` must resume
bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as j_opt
from repro_torch.data.synthetic import lm_batch_for_step
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault_tolerance as ft
from repro_torch.train.optimizer import (adafactor_init, adafactor_update, adamw_init,
                                         adamw_update, clip_by_global_norm, leaves,
                                         make_optimizer)
from repro_torch.train.train_loop import fit, make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"bias": (7,), "w": (6, 5), "experts": (3, 4, 5), "layers.0.norm": (5,),
          "layers.1.norm": (5,), "layers.0.w": (4, 3), "layers.1.w": (4, 3)}


def _tree(dtype, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32).astype(dtype) for k, s in SHAPES.items()}


def _jtree(tree):
    """The reference's layout of the same tree: layers.{i}.X stacked as
    layers.X (its scan stack), the rest as they are."""
    out = {k: v for k, v in tree.items() if not k.startswith("layers.")}
    for key, names in leaves(tree).items():
        if key.startswith("layers."):
            out[key] = np.stack([tree[n] for n in names])
    return {k: jnp.asarray(v) for k, v in out.items()}


def _t(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _ulp_close(got: torch.Tensor, want: np.ndarray, what: str):
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy().astype(np.int32)
        w = np.asarray(want).view(np.int16).astype(np.int32)
        assert np.abs(g - w).max() <= 1, f"{what}: more than one bf16 ulp apart"
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7,
                                   err_msg=what)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_optimizer_matches_the_reference_for_five_steps(name, dtype):
    params_np = _tree(dtype)
    jp = _jtree(params_np)
    tp = {k: _t(v) for k, v in params_np.items()}
    j_init, j_update = j_opt.make_optimizer(name)
    init, update = make_optimizer(name)
    js, ts = j_init(jp), init(tp)
    for step in range(5):
        g_np = _tree(dtype, seed=step + 1)
        jp, js, jn = j_update(_jtree(g_np), js, jp)
        tp, ts, tn = update({k: _t(v) for k, v in g_np.items()}, ts, tp)
        if jn is not None:
            np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        else:
            assert tn is None
    for k, v in tp.items():
        if k.startswith("layers."):
            i = int(k.split(".")[1])
            want = np.asarray(jp["layers." + k.split(".", 2)[2]])[i]
        else:
            want = np.asarray(jp[k])
        _ulp_close(v, want, f"{name} {k}")
    assert int(ts["step"]) == 5
    if name == "adafactor":   # state keyed by the reference's leaves, stacked as there
        assert ts["vr"].keys() == jp.keys()
        assert tuple(ts["vr"]["layers.norm"].shape) == (2,)
        assert tuple(ts["vc"]["layers.w"].shape) == (2, 3)
        for key in jp:
            np.testing.assert_allclose(ts["vr"][key].numpy(), np.asarray(js.vr[key]),
                                       rtol=1e-5, atol=1e-30)
            np.testing.assert_allclose(ts["vc"][key].numpy(), np.asarray(js.vc[key]),
                                       rtol=1e-5, atol=1e-30)


def test_adafactor_in_parts_matches_one_piece(monkeypatch):
    """A leaf past CHUNK is updated in parts (slices of rows for a matrix,
    of axis 0 for an expert tensor); the result is the one-piece update's
    within fp32 rounding."""
    from repro_torch.train import optimizer as opt

    rng = np.random.default_rng(5)
    base = {"m": rng.standard_normal((12, 8)).astype(np.float32),
            "e": rng.standard_normal((6, 4, 5)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in base.items()}
    outs = []
    for chunk in (opt.CHUNK, 16):
        monkeypatch.setattr(opt, "CHUNK", chunk)
        p = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
        s = adafactor_init(p)
        for _ in range(3):
            p, s, _ = adafactor_update({k: torch.from_numpy(v) for k, v in grads.items()}, s, p)
        outs.append((p, s))
    for k in base:
        torch.testing.assert_close(outs[1][0][k], outs[0][0][k], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(outs[1][1]["vc"][k], outs[0][1]["vc"][k], rtol=1e-6,
                                   atol=1e-30)


def _quad():
    target = torch.tensor([1.0, -2.0, 3.0])

    def loss_fn(p, batch):
        return torch.sum((p["w"] - target) ** 2), {}

    return {"w": torch.zeros(3, requires_grad=True)}, loss_fn, target


def test_adamw_converges():
    params, loss_fn, target = _quad()
    state = adamw_init(params)
    for _ in range(300):
        (g,) = torch.autograd.grad(loss_fn(params, None)[0], [params["w"]])
        params, state, _ = adamw_update({"w": g}, state, params, lr=0.05, weight_decay=0.0)
    torch.testing.assert_close(params["w"].detach(), target, atol=0.05, rtol=0)


def test_adafactor_converges():
    target = torch.arange(12.0).reshape(4, 3)
    params = {"w": torch.zeros((4, 3), requires_grad=True)}
    state = adafactor_init(params)
    for _ in range(500):
        (g,) = torch.autograd.grad(torch.sum((params["w"] - target) ** 2), [params["w"]])
        params, state, _ = adafactor_update({"w": g}, state, params, lr=0.3)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1.0


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"a": torch.ones(4) * 10, "b": torch.ones(1)}, 1.0)
    assert float(norm) == pytest.approx(float(np.sqrt(401.0)), rel=1e-6)
    total = torch.sqrt(sum(torch.sum(g ** 2) for g in clipped.values()))
    assert float(total) == pytest.approx(1.0, rel=1e-5)
    same, _ = clip_by_global_norm({"a": torch.full((2,), 0.1, dtype=torch.bfloat16)}, 1.0)
    assert same["a"].dtype == torch.float32 and torch.equal(same["a"],
                                                            torch.full((2,), 0.1).bfloat16().float())


def test_grad_accum_equivalent():
    def loss_b(p, batch):
        return torch.sum((p["w"] - batch["t"]) ** 2) / batch["t"].shape[0], {}

    upd = make_optimizer("adamw", lr=0.1, weight_decay=0.0)[1]
    batch = {"t": torch.stack([torch.ones(3), -torch.ones(3)])}
    outs = []
    for accum, remat in ((1, False), (2, False), (1, True)):
        p = {"w": torch.zeros(3, requires_grad=True)}
        p, _, m = make_train_step(loss_b, upd, grad_accum=accum, remat=remat)(
            p, adamw_init(p), batch)
        outs.append((p["w"].detach(), float(m["loss"])))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-6)
    assert outs[1][1] == pytest.approx(outs[0][1], rel=1e-6)
    # remat (the whole loss checkpointed) recomputes the same function
    assert torch.equal(outs[2][0], outs[0][0]) and outs[2][1] == outs[0][1]


def test_checkpoint_roundtrip_bf16_and_nesting(tmp_path):
    state = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16) / 3},
             "opt": [torch.tensor(7, dtype=torch.int32), torch.zeros(3)]}
    ckpt.save(str(tmp_path), 7, state, extra={"note": "x"})
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored, extra = ckpt.restore(str(tmp_path), 7, state)
    assert extra == {"note": "x"}
    assert torch.equal(restored["a"], state["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"].view(torch.int16), state["b"]["c"].view(torch.int16))
    assert isinstance(restored["opt"], list) and int(restored["opt"][0]) == 7


def test_checkpoint_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, {"a": torch.zeros(1)})
    steps = sorted(p for p in os.listdir(tmp_path) if p.startswith("step_"))
    assert steps == [f"step_{s:010d}" for s in (3, 4, 5)]


def test_checkpoint_leaves_no_partial_directory(tmp_path, monkeypatch):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})

    def boom(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path), 2, {"a": torch.ones(2)})
    assert sorted(os.listdir(tmp_path)) == ["step_0000000001"]
    assert ckpt.latest_step(str(tmp_path)) == 1
    # a step directory without meta.json is not counted
    os.makedirs(tmp_path / "step_0000000009")
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_refuses_a_shape_mismatch(tmp_path):
    ckpt.save(str(tmp_path), 3, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="w"):
        ckpt.restore(str(tmp_path), 3, {"w": torch.zeros((3, 2))})
    with pytest.raises(ValueError, match="v"):
        ckpt.restore(str(tmp_path), 3, {"w": torch.zeros((2, 3)), "v": torch.zeros(1)})


def _fit_kwargs():
    cfg = T.LMConfig(n_layers=1, d_model=32, n_heads=2, n_kv=1, d_head=16, d_ff=64, vocab=64,
                     dtype=torch.float32)
    return dict(init_params_fn=lambda seed: T.init_params(cfg, seed, "cpu"),
                loss_fn=T.loss_fn,
                batch_fn=lambda s: lm_batch_for_step(0, s, 4, 16, 64),
                optimizer="adamw", opt_hp={"lr": 1e-3}, log_every=100)


def test_fit_resumes_bit_identically(tmp_path):
    kw = _fit_kwargs()
    r1 = fit(steps=6, ckpt_dir=None, **kw)
    fit(steps=3, ckpt_dir=str(tmp_path), ckpt_every=100, **kw)
    r2 = fit(steps=6, ckpt_dir=str(tmp_path), ckpt_every=100, **kw)
    for (n, a), (_, b) in zip(r1["params"].named_parameters(), r2["params"].named_parameters()):
        assert torch.equal(a, b), n
    for part in ("m", "v"):
        for n, a in r1["opt_state"][part].items():
            assert torch.equal(a, r2["opt_state"][part][n]), (part, n)
    assert int(r2["opt_state"]["step"]) == 6


def test_run_with_restarts_survives_failures_bit_identically(tmp_path):
    """A real (tiny) LM train step under injected failures: two restarts,
    and the end state equals an uninterrupted run's bit for bit."""
    kw = _fit_kwargs()
    step_fn_of = make_train_step(kw["loss_fn"], make_optimizer("adamw", lr=1e-3)[1])

    def make_state():
        model = kw["init_params_fn"](0)
        named = dict(model.named_parameters())
        return {"params": named, "opt": make_optimizer("adamw")[0](named)}

    def step_fn(step, state):
        model = T.Transformer(T.LMConfig(n_layers=1, d_model=32, n_heads=2, n_kv=1,
                                         d_head=16, d_ff=64, vocab=64,
                                         dtype=torch.float32), "cpu")
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state["params"][n])
        _, opt, _ = step_fn_of(model, state["opt"], kw["batch_fn"](step))
        return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
                "opt": opt}

    calls = {"n": 0}

    def failure_hook(step):
        calls["n"] += 1
        if calls["n"] in (5, 9):   # at steps 4 and 7: both resume from step 4
            raise ft.SimulatedFailure()

    state, info = ft.run_with_restarts(total_steps=10, make_initial_state=make_state,
                                       step_fn=step_fn, ckpt_dir=str(tmp_path / "a"),
                                       ckpt_every=4, failure_hook=failure_hook)
    assert info == {"restarts": 2, "final_step": 10}
    clean, _ = ft.run_with_restarts(total_steps=10, make_initial_state=make_state,
                                    step_fn=step_fn, ckpt_dir=str(tmp_path / "b"), ckpt_every=4)
    flat_a, flat_b = ckpt.flatten(state), ckpt.flatten(clean)
    assert flat_a.keys() == flat_b.keys()
    for key, a in flat_a.items():
        assert torch.equal(a, flat_b[key]), key


def test_run_with_restarts_counts_exact_steps(tmp_path):
    calls = {"n": 0}

    def failure_hook(step):
        calls["n"] += 1
        if calls["n"] in (5, 12):
            raise ft.SimulatedFailure()

    state, info = ft.run_with_restarts(
        total_steps=20, make_initial_state=lambda: {"x": torch.zeros(())},
        step_fn=lambda step, s: {"x": s["x"] + 1.0}, ckpt_dir=str(tmp_path), ckpt_every=4,
        failure_hook=failure_hook)
    assert info["restarts"] == 2 and float(state["x"]) == 20.0


def test_cli_trains_on_the_cpu_and_the_loss_falls(capsys):
    out = train_cli.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                          "--steps", "30"])
    losses = [loss for _, loss in out["history"]]
    assert out["start"] == 0 and [s for s, _ in out["history"]] == [0, 10, 20, 29]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert "[train] step 29 loss=" in capsys.readouterr().out


def test_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train_cli.main(args + ["--steps", "3"])
    assert first["start"] == 0 and ckpt.latest_step(str(tmp_path)) == 3
    second = train_cli.main(args + ["--steps", "5"])
    assert second["start"] == 3 and [s for s, _ in second["history"]] == [4]
    assert "[train] resumed at step 3" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 5


@pytest.mark.parametrize("argv, match", [
    (["--arch", "dlrm-mlperf", "--smoke"], "train.py drives the LM archs"),
    (["--arch", "graphsage-reddit"], "train.py drives the LM archs"),
    (["--arch", "tinyllama-1.1b", "--smoke", "--multi-pod"], "--multi-pod"),
])
def test_cli_refuses_by_name(argv, match, capsys):
    with pytest.raises(SystemExit):
        train_cli.main(argv + ["--device", "cpu"])
    assert match in capsys.readouterr().err
