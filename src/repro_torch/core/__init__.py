"""The single-domain PIC cycle on PyTorch tensors."""
