"""Checkpoint loading and weight-layout conversion."""
