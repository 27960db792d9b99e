"""The port's benchmark and probe modules: the counterparts of
``primekg_rgcn_tpu/bench/``'s suite, scaling harness, pod-scale run, the
config-3 and restricted-layer probes, the collectives' probe
(``psum_probe.py``) and the link-roofline projection
(``ici_roofline.py``), with the card's own floors and links
(``roofline.py``)."""
