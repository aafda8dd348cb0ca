"""The benchmark of gbrl_tpu_torch on an NVIDIA GPU (run.py runs a cell)."""
