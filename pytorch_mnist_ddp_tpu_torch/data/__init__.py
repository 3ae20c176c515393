"""Input data helpers."""
