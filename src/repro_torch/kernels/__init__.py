"""Hand-written Hopper kernels, their plain versions, and the dispatch.

``ops`` is what the rest of the port calls; ``ref`` holds the plain PyTorch
versions; ``gather_distance``, ``distance_matrix``, ``gather_sq8``,
``gather_adc``, ``pq_adc`` and ``flash_attention`` wrap the CUDA sources in
``csrc/``, built at first use by ``_build``.
"""
