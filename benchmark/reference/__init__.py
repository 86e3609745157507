"""Plain PyTorch references the benchmark holds the program to."""
