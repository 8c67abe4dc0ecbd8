"""The benchmark of the PyTorch and CUDA port: training cells on one H100."""
