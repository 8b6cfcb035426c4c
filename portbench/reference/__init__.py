"""The plain reference the benchmark holds the port against: PyTorch
operations only, imports nothing of the system under test."""
