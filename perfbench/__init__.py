"""The benchmark of the admission system's PyTorch and CUDA port."""
