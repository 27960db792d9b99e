"""Share of the recorder's stretch (the port's ``utils/telemetry.
recorded``: the first traced graph run's start to the last one's end, by
CUDA events) in which the device waited between runs, warm-up runs
included. No metric when the recorder saw nothing or another number of
updates than were traced."""


def read(layer, trace):
    try:
        from primekg_rgcn_tpu_torch.utils.telemetry import recorded
    except ImportError:
        return None
    got = recorded()
    if not got["runs"] or got["dropped"] or got["stretch_ms"] <= 0 \
            or got["updates"] != layer.get("updates_traced"):
        return None
    return 100.0 * sum(got["wait_ms"].values()) / got["stretch_ms"]
