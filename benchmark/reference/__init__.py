"""Plain references: NumPy and PyTorch only, nothing of the program under test."""
