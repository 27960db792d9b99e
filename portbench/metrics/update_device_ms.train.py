"""The median over the traced updates of an update's device time: its
graph runs' intervals between the CUDA events that the port's recorder
(``utils/telemetry.recorded``) puts around each run, summed. No metric
when the recorder saw nothing or another number of updates than were
traced."""


def read(layer, trace):
    import statistics

    try:
        from primekg_rgcn_tpu_torch.utils.telemetry import recorded
    except ImportError:
        return None
    got = recorded()
    if not got["runs"] or got["dropped"] \
            or got["updates"] != layer.get("updates_traced") \
            or len(got["update_ms"]) != got["updates"]:
        return None
    return statistics.median(got["update_ms"])
