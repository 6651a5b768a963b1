"""LM models of the port: ``layers`` (blocks), ``transformer`` (the dense
GQA model and its prefill / decode entry points), ``convert`` (the
reference's parameter tree into a model)."""
