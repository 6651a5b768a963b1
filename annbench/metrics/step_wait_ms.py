"""step_wait_ms: milliseconds a beam step the host waits on the device in
the step's one read of ``done.all()`` (``repro_torch.beam.done`` inside
each ``beam.step`` span), over the traced batches' steps
(``_spans.step_split``)."""
from annbench.metrics._spans import step_split


def read(obs):
    split = step_split(obs)
    return None if split is None else split[1]
