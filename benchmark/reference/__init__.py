"""Plain PyTorch references the benchmark holds the program's outputs to.
Nothing here imports the program."""
