"""The benchmark of the PyTorch and CUDA port (``repro_torch``): batched
graph search and index builds on the H100. ``run.py`` runs one cell; see
README.md."""
