"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter (``<module>.launches``)."""
