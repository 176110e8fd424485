"""The benchmark of alignasm_tpu_torch: see run.py."""
