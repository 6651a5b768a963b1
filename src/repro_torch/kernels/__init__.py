"""Hand-written Hopper kernels, their plain versions, and the dispatch.

``ops`` is what the rest of the port calls; ``ref`` holds the plain PyTorch
versions; ``gather_distance`` and ``distance_matrix`` wrap the CUDA sources
in ``csrc/``, built at first use by ``_build``.
"""
