"""device_idle_pct.build: share (%) of the traced build window with no
kernel running on the device (the union of the profiler's device ops)."""
from annbench.metrics._idle import idle_of


def read(obs):
    return idle_of(obs, "build")
