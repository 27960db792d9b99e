"""Sharded layouts, driven by one process over the shards of a mesh."""
