"""Scripts of the port, run as modules (`python -m
bitdistiller_tpu_torch.scripts.bw_probe`)."""
