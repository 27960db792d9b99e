"""The benchmark of ``primekg_rgcn_tpu_torch``, the PyTorch and CUDA port:
one cell a run, ``python -m portbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (see ``README.md``)."""
