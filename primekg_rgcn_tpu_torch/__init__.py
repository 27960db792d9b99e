"""PyTorch + CUDA port of the RGCN link-prediction framework for one H100.

The JAX package ``primekg_rgcn_tpu`` is the reference; every module here
keeps the name of its counterpart there. This package imports ``torch`` and
never ``jax`` or the JAX package. Entry points run on ``cuda`` unless the
caller asks for ``cpu``; on a CPU tensor each hand-written kernel's wrapper
runs the kernel's plain PyTorch version instead.
"""
