"""PyTorch/CUDA port of the GENESYS reproduction, beside the JAX package
``repro``: the same host syscall plane (copied, not imported), the dense
transformer's paged decode step in PyTorch, and hand-written Hopper
kernels in ``kernels/csrc``. Entry points run on the GPU unless the
caller passes ``device="cpu"``."""
