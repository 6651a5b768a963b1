"""The port's LM token stream and data pipeline on the CPU, the
counterparts of ``tests/test_data_pipeline.py``.

The stream's formula (``synthetic.lm_tokens``) fed the reference's own
``jax.random`` draws gives the reference's tokens and labels exactly; the
port's own draws come from a ``torch.Generator`` seeded from (seed, step),
so its batches agree with the reference's in law, and the pipeline's
contracts (determinism, host slices, resume, topology) hold bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch.data import synthetic
from repro_torch.data.pipeline import (Pipeline, PipelineSpec, bert4rec_cloze, global_batch,
                                       host_slice)


@pytest.mark.parametrize("seed, step", [(0, 0), (0, 7), (3, 11)])
def test_lm_tokens_on_the_reference_draws_are_the_reference_batch(seed, step):
    batch, seq, vocab = 4, 32, 97
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.randint(k1, (batch, 1), 1, 17),
             jax.random.randint(k2, (batch, 1), 0, vocab),
             jax.random.bernoulli(k3, 0.05, (batch, seq)),
             jax.random.randint(k3, (batch, seq), 0, vocab))
    got = synthetic.lm_tokens(*(torch.from_numpy(np.asarray(d)) for d in draws), vocab)
    want = jsyn.lm_batch_for_step(seed, step, batch, seq, vocab)
    for name in ("tokens", "labels"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_lm_batch_law_and_determinism():
    a = synthetic.lm_batch_for_step(0, 7, 64, 128, 1000)
    b = synthetic.lm_batch_for_step(0, 7, 64, 128, 1000)
    c = synthetic.lm_batch_for_step(0, 8, 64, 128, 1000)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], c["tokens"])
    toks = a["tokens"]
    assert toks.shape == (64, 128) and int(toks.min()) >= 0 and int(toks.max()) < 1000
    assert bool((a["labels"][:, -1] == -100).all())
    assert torch.equal(a["labels"][:, :-1], toks[:, 1:])
    # the affine recurrence holds except at the ~5% noise positions
    step = (toks[:, 1:] - toks[:, :-1]) % 1000
    mode = torch.mode(step, dim=1).values[:, None]
    assert 0.85 < float((step == mode).float().mean()) < 0.95


def test_global_batch_deterministic():
    spec = PipelineSpec(kind="lm", batch=8, seq=16, vocab=64)
    assert torch.equal(global_batch(spec, 7)["tokens"], global_batch(spec, 7)["tokens"])
    assert not torch.equal(global_batch(spec, 7)["tokens"], global_batch(spec, 8)["tokens"])


def test_host_slices_tile_the_global_batch():
    spec = PipelineSpec(kind="lm", batch=16, seq=8, vocab=64)
    g = global_batch(spec, 3)
    for name in ("tokens", "labels"):
        parts = [host_slice(g, h, 4)[name] for h in range(4)]
        assert torch.equal(torch.cat(parts), g[name])


def test_pipeline_resume_bit_exact():
    spec = PipelineSpec(kind="lm", batch=4, seq=8, vocab=32)
    p1 = Pipeline(spec)
    seq_a = [p1.next()["tokens"] for _ in range(6)]
    p2 = Pipeline(spec)
    for _ in range(3):
        p2.next()
    p3 = Pipeline(spec)
    p3.restore(p2.state())
    assert p2.state() == {"step": 3}
    for a, b in zip(seq_a[3:], [p3.next()["tokens"] for _ in range(3)]):
        assert torch.equal(a, b)


def test_topology_independent_sequence():
    spec = PipelineSpec(kind="lm", batch=8, seq=8, vocab=32)
    two = [Pipeline(spec, host_id=h, num_hosts=2, start_step=5).next()["tokens"]
           for h in range(2)]
    assert torch.equal(torch.cat(two), Pipeline(spec, start_step=5).next()["tokens"])


def test_bert4rec_pipeline_contract():
    spec = PipelineSpec(kind="bert4rec", batch=4, seq=20, n_items=100, mask_token=100,
                        n_masked=5)
    b = global_batch(spec, 0)
    assert b["items"].shape == (4, 20)
    assert b["masked_pos"].shape == (4, 5) and b["labels"].shape == (4, 5)
    assert bool((torch.gather(b["items"], 1, b["masked_pos"].long()) == 100).all())
    assert bool((b["labels"] < 100).all())
    assert all(len(set(row.tolist())) == 5 for row in b["masked_pos"])
    assert torch.equal(global_batch(spec, 0)["items"], b["items"])


def test_bert4rec_cloze_on_the_reference_draws_is_the_reference_batch():
    spec = jpipe.PipelineSpec(kind="bert4rec", batch=4, seq=20, n_items=100, mask_token=100,
                              n_masked=5)
    key = jax.random.fold_in(jax.random.PRNGKey(spec.seed), 2)
    k1, k2, kp = jax.random.split(key, 3)
    step_sz = jax.random.randint(k1, (spec.batch, 1), 1, 7)
    start = jax.random.randint(k2, (spec.batch, 1), 0, spec.n_items)
    pos = jax.vmap(lambda k: jax.random.choice(k, spec.seq, (spec.n_masked,), replace=False))(
        jax.random.split(kp, spec.batch)).astype(jnp.int32)
    got = bert4rec_cloze(*(torch.from_numpy(np.asarray(x)).long() for x in (step_sz, start, pos)),
                         spec.n_items, spec.seq, spec.mask_token)
    want = jpipe.global_batch(spec, 2)
    for name in ("items", "masked_pos", "labels"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("kind", ["recsys", "gnn-minibatch"])
def test_unported_kinds_name_the_queue_item(kind):
    """``recsys`` gives the reference's batch contract (keys, shapes,
    dtypes; a pure function of the step); ``gnn-minibatch`` has no batch in
    either package: a ValueError naming the kind."""
    fields = dict(kind=kind, batch=8, vocab_sizes=(8, 5, 300), n_dense=4)
    if kind == "gnn-minibatch":
        for spec, fn in ((PipelineSpec(**fields), global_batch),
                         (jpipe.PipelineSpec(**fields), jpipe.global_batch)):
            with pytest.raises(ValueError, match="gnn-minibatch"):
                fn(spec, 0)
        return
    got = global_batch(PipelineSpec(**fields), 3)
    want = jpipe.global_batch(jpipe.PipelineSpec(**fields), 3)
    assert list(got) == list(want) == ["sparse", "dense", "label"]
    for name in want:
        assert got[name].shape == want[name].shape
        assert got[name].numpy().dtype == np.asarray(want[name]).dtype
    assert bool((got["sparse"] < torch.tensor([8, 5, 300])).all())
    assert set(got["label"].tolist()) <= {0.0, 1.0}
    again = global_batch(PipelineSpec(**fields), 3)
    assert all(torch.equal(got[k], again[k]) for k in got)
