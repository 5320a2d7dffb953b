"""The plain float32 reference of both configurations: plain PyTorch, no
kernel, no cache, nothing of the program."""
