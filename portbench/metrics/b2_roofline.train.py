"""Kernel B2's bound over the traced updates' restricted final layers (one
B2 call each, none in an update that fell back to the full layer) over
B2's device time in the trace."""

from portbench.yardstick.roofline import restricted_b2_bound_s


def read(layer, trace):
    if trace is None or not layer.get("restricted") \
            or trace.family_s.get("B2", 0.0) <= 0:
        return None
    calls = layer["updates_traced"] - layer["fallbacks_traced"]
    bound = calls * restricted_b2_bound_s(
        layer["e_cap_total"], layer["group"], layer["num_relations"],
        layer["batch_nodes"], layer["d_hid"])
    return 100.0 * bound / trace.family_s["B2"]
