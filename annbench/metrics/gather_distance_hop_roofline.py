"""gather_distance_hop_roofline: the beam's hop kernel
(``gather_distance_hop_kernel``) against its least time at 3.35 TB/s. The
bytes are the benchmark's own count (``_lib.hop_bytes``) from the traced
batches' ``n_comps``, steps and shape; the time is the kernel's device time
by symbol in the traced window. Where the profiler kept fewer launches than
the batches made, the time is scaled up per kept launch."""
from annbench.metrics._lib import HOP_KERNEL, hop_bytes, roofline_pct


def read(obs):
    tr = obs.get("trace")
    if not tr or "search" not in tr:
        return None
    s = tr["search"]
    seconds, kept = tr["timeline"].op_seconds(HOP_KERNEL)
    launches = s["batches"] + sum(s["steps"])     # the seed scoring + one a step
    if kept == 0 or kept > launches:
        return None
    slots = s["rows"] * s["E"] + s["rows"] * s["R"] * sum(s["steps"]) // s["batches"]
    nbytes = hop_bytes(s["comps"], slots, s["R"], s["d"])
    return roofline_pct(nbytes, seconds * launches / kept)
