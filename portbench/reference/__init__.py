"""The plain reference: PyTorch operations in float64 (bfloat16 for the
control), independent of the program; it imports nothing of it."""
