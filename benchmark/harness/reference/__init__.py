"""Plain references: PyTorch and NumPy only, nothing of the port.

Each works out again, from the inputs the benchmark made, what the port
derives from them, in float64 unless a control asks for a lower
precision.
"""
