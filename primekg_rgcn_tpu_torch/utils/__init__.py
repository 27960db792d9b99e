"""Telemetry: metrics stream, device memory counters, profiler traces."""
