"""Layer ops: the dense oracle, the relation-bucketed convolution over the
CUDA gather + segment-sum kernel, and DistMult scoring."""
