"""KD-QAT training of the port (PyTorch port of the JAX package's `train`):
losses, the trainer (optimizer, train steps, CAKLD beta), the teacher-data
pipeline, the memory estimate and `run_training`."""
