"""RG-LRU linear recurrence: CUDA kernel (``csrc/``), wrapper (``ops``),
plain PyTorch version (``ref``)."""
