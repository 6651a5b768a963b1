"""Training: optimizers, the train step and ``fit``, checkpoints, restarts
(``repro/train``)."""
