"""JAX's threefry2x32 sampler: CUDA kernel (``csrc/``), wrapper (``ops``),
plain PyTorch version (``ref``)."""
