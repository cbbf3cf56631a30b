"""Hand-written CUDA kernels of the port and their plain PyTorch versions:
`quant_matmul` (packed dequantize-matmul) and `decode_attention` (stacked
S=1 decode attention). `_build` compiles and loads csrc/*.cu."""
