"""Synthetic data for the port: the paper's ANN datasets (``synthetic``)."""
