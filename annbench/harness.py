"""One run of one cell: set-up, the measured window, an optional profiled
window, the comparison with the reference, and the result line.

Everything is found by name: the cell in BENCHMARK.json's ``workloads`` and
in ``workloads/<cell>.json`` (its configuration, traffic driver, driver
parameters and the limits of the numbers compared), the configuration's
file as BENCHMARK.json names it, the driver in ``traffic/<driver>.py`` and
each per-layer metric's reader in ``metrics/<metric>.py``. A new cell,
configuration or metric is a new file and a new entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from annbench.metrics._lib import profile_window

HERE = Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The cell's chips are not visible."""


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def bench_dir(root: Path) -> Path:
    """This benchmark's folder in the checkout at ``root``."""
    return root / HERE.name


def load_cell(root: Path, name: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json's entry, workloads/<name>.json, the configuration)
    of the cell ``name``."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = json.loads((bench_dir(root) / "workloads" / f"{name}.json").read_text())
    if cell["config"] != entry["config"]:
        raise ValueError(f"cell {name}: config {cell['config']!r} but BENCHMARK.json "
                         f"says {entry['config']!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    return entry, cell, config


def _load_file(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(root: Path, name: str):
    """``Driver`` of ``traffic/<name>.py``."""
    return _load_file(bench_dir(root) / "traffic" / f"{name}.py",
                      f"annbench.traffic.driver_{name}").Driver


def load_reader(root: Path, name: str):
    """``read`` of ``metrics/<name>.py`` (a name may hold dots)."""
    return _load_file(bench_dir(root) / "metrics" / f"{name}.py",
                      f"annbench.metrics.reader_{name}").read


def cell_metrics(bench: dict, kind: str, cell: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def check_gpu(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, each compared number with its limit): correct where every
    number is at or under its limit."""
    checks = {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def log(msg: str) -> None:
    print(f"[annbench] {msg}", file=sys.stderr, flush=True)


def run(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", require_gpu: bool = True,
        overrides: dict | None = None, out=None) -> int:
    """Run the cell once and print its result line; returns the exit code.
    ``device`` "cpu" with ``require_gpu`` False and small ``overrides``
    ({"config": ..., "params": ..., "limits": ...}) drives the same path on
    the CPU for the tests."""
    out = out or sys.stdout
    bench = load_benchmark(root)
    entry, cell, config = load_cell(root, cell_name)
    if require_gpu:
        try:
            check_gpu(entry["chips"])
        except NoDevice as e:
            log(f"no result: {e}")
            return 2
    overrides = overrides or {}
    config = merge(config, overrides.get("config"))
    params = merge(cell["params"], overrides.get("params"))
    limits = merge(cell["limits"], overrides.get("limits"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    on_gpu = dev.type == "cuda"

    drv = load_driver(root, cell["driver"])(config, params, seed, dev)
    drv.setup()
    if on_gpu:
        torch.cuda.synchronize(dev)
    obs = {"cell": cell_name, "setup_s": time.perf_counter() - t_start}
    log(f"{cell_name} seed {seed}: set-up {obs['setup_s']:.3f} s")
    drv.window(seconds, obs)
    log(f"window {obs['window_s']:.3f} s, {obs['attempted']} attempted, e2e {obs['e2e']}; "
        f"{obs.get('detail', '')}")
    if trace:
        obs["trace"] = drv.traced(
            lambda fn: profile_window(fn, tries=5 if on_gpu else 1, log=log))
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_gpu else 0
    loaded = forbidden_loaded()
    drv.release()
    t_check = time.perf_counter()
    readings = drv.check(obs)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    obs["e2e"]["setup_s"] = obs["setup_s"]

    metrics = {}
    for m in cell_metrics(bench, "per_layer" if trace else "end_to_end", cell_name):
        value = load_reader(root, m["name"])(obs) if trace else obs["e2e"][m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = judge(readings, limits)
    device_info = {"platform": "gpu" if on_gpu else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": obs["attempted"], "failed": obs["failed"],
              "metrics": metrics, "device": device_info}
    if trace:
        tl = obs["trace"]["timeline"]
        device_info.update(busy_s=tl.busy_s(), window_s=tl.window_s)
        result["breakdown"] = {"device_ops": tl.top_ops(), "idle_gaps": tl.idle_gaps()}
    result["card"] = card_line() if on_gpu else "cpu"
    result["readings"] = {k: v for k, v in readings.items() if k not in checks}
    result["checks"] = checks

    loaded = sorted(set(loaded) | set(forbidden_loaded()))
    if loaded:
        log(f"no result: JAX or the JAX package was loaded: {', '.join(loaded)}")
        return 3
    log(f"readings not compared: {result['readings']}")
    print(json.dumps(result), file=out, flush=True)
    for name, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr,
              flush=True)
    return 0
