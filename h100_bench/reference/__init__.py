"""Plain references, one per driver: plain PyTorch that imports nothing
of the program."""
