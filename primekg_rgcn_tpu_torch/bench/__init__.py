"""The port's benchmark and probe modules: the counterparts of
``primekg_rgcn_tpu/bench/``'s suite, scaling harness, pod-scale run and
the config-3 and restricted-layer probes, with the card's own floors
(``roofline.py``)."""
