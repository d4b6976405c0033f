"""Tensor ops of the PyTorch port: links, matmul, losses, line search."""
