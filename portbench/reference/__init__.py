"""The benchmark's plain reference: float64 NumPy and PyTorch, importing
nothing of the program and taking nothing the program made."""
