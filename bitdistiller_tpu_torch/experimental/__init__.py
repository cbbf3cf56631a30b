"""Opt-in entry points of the JAX package's `experimental/`, ported with
their kernels and kept out of the default import graph as there:

- flash_decode: `flash_decode_attention`, the first-generation per-layer
  S=1 decode attention; on the card it launches the stacked decode
  attention kernel (csrc/decode_attention.cu) on one layer's cache.
- fused_mlp: `fused_mlp`, the one-launch packed gate/up/down MLP
  (csrc/fused_mlp.cu). No model hook, as in the JAX package.
"""
