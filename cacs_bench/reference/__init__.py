"""Plain PyTorch and NumPy references for the benchmark's correctness checks.

Nothing here imports the program under test or JAX: each module works out
again, from the inputs the benchmark made, what the program computed.
"""
