"""Data and tensor parallelism of the port (the JAX package's `parallel`
but its ring matmuls and GPipe): process groups and per-rank data
(`distributed`), the (dp, tp) mesh, the spec tables and each rank's slice
of a tree (`mesh`), Megatron's explicit tp collectives (`tensor`), and the
ZeRO placement of the train state over dp (`zero`)."""
