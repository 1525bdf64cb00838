"""Hand-written CUDA kernels for Hopper (csrc/), their plain PyTorch
versions (ref.py), the build (build.py) and the wrappers (ops.py)."""
