"""The update's required float32 operations (``yardstick/roofline.
update_flops``, counted from shapes, not by the program) over the traced
stretch's time an update at the card's float32 peak."""

from portbench.yardstick.roofline import F32_FLOPS


def read(layer, trace):
    if trace is None or not layer.get("updates_traced") \
            or not layer.get("update_flops"):
        return None
    per_update_s = trace.window_s / layer["updates_traced"]
    return 100.0 * layer["update_flops"] / (per_update_s * F32_FLOPS)
