"""step_launch_ms: the host's own milliseconds a beam step, issuing its
work: each ``repro_torch.beam.step`` span (``core/beam_search.py``) less
its ``beam.done`` read, summed over the traced batches' steps and divided
by their number (``_spans.step_split``)."""
from annbench.metrics._spans import step_split


def read(obs):
    split = step_split(obs)
    return None if split is None else split[0]
