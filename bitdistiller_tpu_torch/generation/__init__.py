"""Teacher self-generation (`teacher.py`) and its prompt sources
(`datasets.py`)."""
