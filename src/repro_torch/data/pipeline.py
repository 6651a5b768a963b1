"""Deterministic, shardable data pipeline, as ``repro/data/pipeline.py``.

A batch is a pure function of (seed, step), so resume is bit-exact from any
checkpoint (the step index is the pipeline's state and travels in the
checkpoint); each host materializes only its rows (``host_slice`` cuts the
global batch by (host_id, num_hosts)); and a rescaled job that changes
num_hosts sees the same global batch at each step. The draws come from a
CPU ``torch.Generator`` seeded from (seed, step) (``synthetic.step_seed``),
not from threefry, so batches agree with the reference's in law, not bit
for bit. Kinds: ``lm``, ``recsys`` and ``bert4rec``; ``gnn-minibatch`` is
named in the spec but, as in the reference, has no batch (``ValueError``).
"""
from __future__ import annotations

import dataclasses

import torch

from . import synthetic


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    kind: str                  # 'lm' | 'recsys' | 'bert4rec' | 'gnn-minibatch'
    seed: int = 0
    batch: int = 8
    # lm
    seq: int = 128
    vocab: int = 1024
    # recsys
    vocab_sizes: tuple[int, ...] = ()
    n_dense: int = 0
    # bert4rec
    n_items: int = 0
    mask_token: int = 0
    n_masked: int = 40


def bert4rec_cloze(step_sz: torch.Tensor, start: torch.Tensor, pos: torch.Tensor,
                   n_items: int, seq: int, mask_token: int) -> dict:
    """The reference's bert4rec batch from its draws: markov item sequences
    (start + step_sz * t) % n_items for step_sz (B, 1) in [1, 7) and start
    (B, 1) in [0, n_items), and a fixed count of cloze positions pos (B,
    n_masked), distinct in each row -> {items (masked positions set to
    mask_token), masked_pos, labels (the items there)}, all int32."""
    seqs = (start + step_sz * torch.arange(seq, device=start.device)[None, :]) % n_items
    labels = torch.gather(seqs, 1, pos).to(torch.int32)
    items = seqs.scatter(1, pos, mask_token).to(torch.int32)
    return {"items": items, "masked_pos": pos.to(torch.int32), "labels": labels}


def global_batch(spec: PipelineSpec, step: int) -> dict:
    """The full (host-independent) batch for ``step``, on the CPU."""
    if spec.kind == "lm":
        return synthetic.lm_batch_for_step(spec.seed, step, spec.batch, spec.seq, spec.vocab)
    if spec.kind == "bert4rec":
        gen = torch.Generator().manual_seed(synthetic.step_seed(spec.seed, step))
        step_sz = torch.randint(1, 7, (spec.batch, 1), generator=gen)
        start = torch.randint(0, spec.n_items, (spec.batch, 1), generator=gen)
        pos = torch.stack([torch.randperm(spec.seq, generator=gen)[:spec.n_masked]
                           for _ in range(spec.batch)])
        return bert4rec_cloze(step_sz, start, pos, spec.n_items, spec.seq, spec.mask_token)
    if spec.kind == "recsys":
        gen = torch.Generator().manual_seed(synthetic.step_seed(spec.seed, step))
        return synthetic.recsys_batch(gen, spec.batch, spec.vocab_sizes, spec.n_dense)
    raise ValueError(spec.kind)


def host_slice(batch: dict, host_id: int, num_hosts: int) -> dict:
    """The rows this host feeds its devices (contiguous in the leading dim)."""
    def cut(x):
        per = x.shape[0] // num_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: cut(v) for k, v in batch.items()}


class Pipeline:
    """Iteration with a checkpointable cursor."""

    def __init__(self, spec: PipelineSpec, host_id: int = 0, num_hosts: int = 1,
                 start_step: int = 0):
        self.spec = spec
        self.host_id, self.num_hosts = host_id, num_hosts
        self.step = start_step

    def next(self) -> dict:
        b = host_slice(global_batch(self.spec, self.step), self.host_id, self.num_hosts)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
