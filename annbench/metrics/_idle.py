"""The device's idle share over the traced window, shared by the
``device_idle_pct.*`` readers."""
from annbench.metrics._lib import idle_pct


def idle_of(obs, kind: str):
    tr = obs.get("trace")
    if not tr or kind not in tr:
        return None
    tl = tr["timeline"]
    return idle_pct(tl.busy_s(), tl.window_s)
