"""Hand-written CUDA kernels for Hopper, one module each, each beside its
plain PyTorch version."""
