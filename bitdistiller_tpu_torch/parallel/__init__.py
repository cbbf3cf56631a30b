"""Data parallelism of the port (the dp half of the JAX package's
`parallel`): process groups and per-rank data (`distributed`), the dp spec
table and ZeRO's split rule (`mesh`), and the ZeRO placement of the train
state with its explicit collectives (`zero`). Tensor parallelism (the
Megatron specs, ring matmuls, GPipe) is not ported yet."""
