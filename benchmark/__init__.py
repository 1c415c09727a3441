"""The benchmark of abcnet_tpu_torch on NVIDIA GPUs (see run.py)."""
