"""build_report_s: seconds a build spends outside its timed stages: the
graph-recall proxy (``repro_torch.build.proxy``) and the report's hubs, LID,
degree statistics and memory (``build.report``), ``core/build.py``, summed
over the traced builds and divided by their number."""
from annbench.metrics._spans import build_phases, seconds


def read(obs):
    proxy, report = build_phases(obs, "build.proxy"), build_phases(obs, "build.report")
    if proxy is None or not report[1]:
        return None
    return (seconds(proxy[1]) + seconds(report[1])) / proxy[0]
