"""The benchmark of mrijax_torch on one NVIDIA H100 (see harness.py)."""
