"""Plain PyTorch references of what the cells run. They import nothing of
the program."""
