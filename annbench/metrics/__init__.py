"""Per-layer metric readers, one file per metric named as in
BENCHMARK.json (``<name>.py``, each with ``read(obs) -> float | None``), and
the arithmetic they share (``_lib``)."""
