"""Graph build, beam search and brute force for the PyTorch port."""
