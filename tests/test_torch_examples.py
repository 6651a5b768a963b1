"""The port's quickstart and train_lm examples on the CPU, each beside the
unedited reference example, in children (all started as the module starts).

* ``quickstart`` at ``--scale 0.005`` (n = 5,000, d = 128): default mode,
  ``--serve`` and ``--ladder``. Each exits 0, so its asserts hold (the
  artifact round trip, served == direct, disk == host rerank, each bit for
  bit), prints the reference's lines, and the mean of its recall@1 lines
  is at least the reference's less ``RECALL_SLACK`` (0.02), each line the
  reference's less ``LINE_SLACK``. The two packages draw the synthetic
  SIFT1M rows and the search's entry points from their own generators, so
  a line at ef = 16 differs by chance (0.945 against 0.985 seen); the
  reference's own lines move by 0.01 from run to run.
* Every child runs on one thread (``OMP_NUM_THREADS=1``, XLA's single-
  threaded Eigen), eight at once.
* ``train_lm --steps 40``: the loss falls in both packages (each asserts
  it), and the port's last loss is within ``LOSS_TOL`` of the reference's
  (the same model and stream law, other draws of weights and tokens).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
RECALL_SLACK = 0.02       # the mean of a mode's recall@1 lines
LINE_SLACK = 0.065        # any one line: 3 standard errors of a difference of two
#                           recalls near 0.95 over 200 queries
LOSS_TOL = 0.1
ONE_THREAD = dict(OMP_NUM_THREADS="1",
                  XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
TIMEOUT_S = 400
MODES = {"default": [], "serve": ["--serve"], "ladder": ["--ladder"]}
RECALL = re.compile(r"^(.*?): ?recall@1=([0-9.]+)", re.M)
LOSS = re.compile(r"^loss: ([0-9.]+) -> ([0-9.]+)", re.M)


def _start(args, **env):
    return subprocess.Popen([sys.executable, *args], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH="src", **ONE_THREAD, **env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    ck = tmp_path_factory.mktemp("ckpt")
    procs = {}
    for mode, flags in MODES.items():
        procs["port", mode] = _start(["examples/quickstart_torch.py", "--device", "cpu",
                                      "--scale", "0.005", *flags])
        procs["ref", mode] = _start(["examples/quickstart.py", "--scale", "0.005", *flags],
                                    JAX_PLATFORMS="cpu")
    procs["port", "train"] = _start(["examples/train_lm_torch.py", "--device", "cpu",
                                     "--steps", "40", "--ckpt-dir", str(ck / "port")])
    procs["ref", "train"] = _start(["examples/train_lm.py", "--steps", "40", "--ckpt-dir",
                                    str(ck / "ref")], JAX_PLATFORMS="cpu")
    done = {}

    def get(side, mode):
        if (side, mode) not in done:
            p = procs[side, mode]
            out, err = p.communicate(timeout=TIMEOUT_S)
            done[side, mode] = (p.returncode, out, err)
        return done[side, mode]

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("mode", list(MODES))
def test_quickstart_runs_at_the_references_recall(runs, mode):
    rc, out, err = runs("port", mode)
    assert rc == 0, err[-2000:]
    jrc, jout, jerr = runs("ref", mode)
    assert jrc == 0, jerr[-2000:]
    assert re.search(r"dataset: n=5000 d=128 metric=l2", out)
    got, want = RECALL.findall(out), RECALL.findall(jout)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert (got != []) == (mode != "serve")    # --serve prints no recall
    for (label, r), (_, jr) in zip(got, want):
        assert float(r) >= float(jr) - LINE_SLACK, (label, r, jr)
    if got:
        mean, jmean = (sum(float(r) for _, r in x) / len(x) for x in (got, want))
        assert mean >= jmean - RECALL_SLACK, (mean, jmean)
    if mode == "default":
        assert "bit-identical=True" in out and "(built by: nndescent)" in out
    if mode == "serve":
        assert "served answers bit-match direct Searcher.search: True" in out
        assert out.count("serve @") == 2
    if mode == "ladder":
        assert "bit-identical to host rerank=True" in out


def test_train_lm_loss_falls_beside_the_references(runs):
    rc, out, err = runs("port", "train")
    assert rc == 0, err[-2000:]
    jrc, jout, jerr = runs("ref", "train")
    assert jrc == 0, jerr[-2000:]
    (first, last), = [tuple(map(float, m)) for m in LOSS.findall(out)]
    (jfirst, jlast), = [tuple(map(float, m)) for m in LOSS.findall(jout)]
    assert last < first and jlast < jfirst
    assert abs(last - jlast) <= LOSS_TOL, (last, jlast)
