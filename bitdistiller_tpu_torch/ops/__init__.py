"""Hand-written CUDA kernels of the port and their plain PyTorch versions:
`quant_matmul` (packed dequantize-matmul, A16 and W{2,4}A8),
`decode_attention` (stacked S=1 decode attention) and `train_attention`
(the training flash attention, forward and backward). `_build` compiles
and loads csrc/*.cu."""
