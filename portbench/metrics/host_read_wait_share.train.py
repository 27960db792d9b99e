"""Share of the recorder's stretch (the port's ``utils/telemetry.
recorded``, by CUDA events) in which the device waited on the restricted
update's host read of its overflow flags (waits named
``restricted.host_read``). No metric without the restricted layer, when
the recorder saw nothing or another number of updates than were
traced."""


def read(layer, trace):
    try:
        from primekg_rgcn_tpu_torch.utils.telemetry import recorded
    except ImportError:
        return None
    got = recorded()
    if not layer.get("restricted") or not got["runs"] or got["dropped"] \
            or got["stretch_ms"] <= 0 \
            or got["updates"] != layer.get("updates_traced"):
        return None
    return (100.0 * got["wait_ms"].get("restricted.host_read", 0.0)
            / got["stretch_ms"])
