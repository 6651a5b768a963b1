"""Traffic drivers, one file per driver named by a cell's ``driver`` key:
each holds a ``Driver(config, params, seed, device)`` with ``setup``,
``window``, ``traced``, ``release``, ``check`` and ``control``."""
