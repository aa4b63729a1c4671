"""Single-token GQA decode attention: CUDA kernel (``csrc/``), wrapper
(``ops``), plain PyTorch version (``ref``)."""
