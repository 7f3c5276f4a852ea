"""The plain references the benchmark holds the program's outputs to.

Nothing here imports the program under test or JAX.
"""
