"""Share of the traced stretch in which no kernel, copy or set ran on the
device: 1 - busy / window, between the harness's marker kernels."""


def read(layer, trace):
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
