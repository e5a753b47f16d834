"""The benchmark of legommenders_tpu_torch on one H100 (see run.py)."""
