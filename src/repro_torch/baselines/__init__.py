"""Baselines the paper compares graph search with (fig3): product
quantization (``pq``), the SRS projection LSH (``lsh``) and the RP-tree
forest (``tree``)."""
