"""Calibration data for AutoClip (`calib.py`) and the offline dataset
redirect (`offline.py`)."""
