"""Eq. 31 masked zone update: CUDA kernel (``csrc/``), wrapper (``ops``),
plain PyTorch version (``ref``)."""
