"""Checkpoints and parameter interop (training itself is still to port)."""
