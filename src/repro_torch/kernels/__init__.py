"""CUDA kernels (``csrc/``) with their plain PyTorch versions; ``ops``
picks one by the device of the tensors."""
