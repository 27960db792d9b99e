"""Kernel B1's bound over the traced updates' B1 calls (conv1 forward and
backward in every update; conv2's too where the full final layer ran),
each call reading its bucket's distinct rows of the table, over B1's
device time in the trace."""

from portbench.yardstick.roofline import full_layer_b1_bound_s


def read(layer, trace):
    if trace is None or trace.family_s.get("B1", 0.0) <= 0:
        return None
    u = layer["updates_traced"]
    full_conv2 = layer["fallbacks_traced"] if layer["restricted"] else u
    buckets = (layer["bucket_sizes"], layer["bucket_src_rows"],
               layer["bucket_dst_rows"], layer["num_nodes"])
    # Each layer aggregates at the narrower of its widths.
    d1 = min(layer["d_emb"], layer["d_hid"])
    d2 = layer["d_hid"]
    bound = (u * full_layer_b1_bound_s(*buckets, d1, scaled=layer["scaled"])
             + full_conv2 * full_layer_b1_bound_s(*buckets, d2,
                                                  scaled=layer["scaled"]))
    return 100.0 * bound / trace.family_s["B1"]
