"""Telemetry: the named metrics registry and its Prometheus rendering."""
