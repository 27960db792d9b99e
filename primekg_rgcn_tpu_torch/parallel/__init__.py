"""Sharded layouts, driven by one process over the shards of a mesh, or
(the edge layout) by each process of a group over its own shards."""
