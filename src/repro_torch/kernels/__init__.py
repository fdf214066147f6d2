"""Hand-written CUDA kernels, their launch wrappers and plain PyTorch versions."""
