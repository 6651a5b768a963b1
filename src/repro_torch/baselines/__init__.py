"""Baselines the paper compares graph search with; this package ports the
product-quantization baseline (``pq``) and the SRS projection LSH (``lsh``)."""
