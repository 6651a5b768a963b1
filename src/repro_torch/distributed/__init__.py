"""Distributed layers of the port on ``torch.distributed``: shard-and-merge
ANN search and the per-shard build (``sharded_ann``), and gradient
compression for the data-parallel all-reduce (``compression``)."""
