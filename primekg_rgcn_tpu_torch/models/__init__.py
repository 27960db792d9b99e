"""RGCN encoder + DistMult decoder."""
