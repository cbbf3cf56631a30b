"""PyTorch/CUDA port of bitdistiller_tpu: packed low-bit serving and KD-QAT
training.

Sub-packages mirror the JAX package's names (`models`, `quant`, `ops`,
`serve`, `train`). The hot-path kernels are hand-written CUDA for Hopper
(sm_90a) under `csrc/`, built with nvcc at first use into `_build/` and
bound with ctypes (`ops/_build.py`). Every entry point runs on the card
unless the caller passes `device="cpu"`, where the plain PyTorch versions
run.
"""
