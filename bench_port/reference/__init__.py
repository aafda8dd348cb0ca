"""The plain reference that decides ``correct``: NumPy and PyTorch only,
nothing of the program under test (bench_port/tests checks the imports)."""
