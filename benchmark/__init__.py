"""The benchmark of reconstructor_tpu_torch (see run.py)."""
