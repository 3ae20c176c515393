"""Checkpoints, weight-layout conversion, run seeds and the printed lines."""
