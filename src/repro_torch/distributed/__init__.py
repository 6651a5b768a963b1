"""Distributed layers of the port on ``torch.distributed``: shard-and-merge
ANN search and the per-shard build (``sharded_ann``), gradient compression
for the data-parallel all-reduce (``compression``), and the DTensor
placements of the LM meshes' specs with the ``local_map`` bodies of the ops
DTensor has no rule for (``sharding``)."""
