"""Hand-written CUDA kernels of the port, their wrappers and plain PyTorch
versions. Kernels build at first use (``_build``), never at import."""
