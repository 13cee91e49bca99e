"""Share of the traced window in which the card ran neither a kernel nor
a copy (the union of the device's intervals, from the profiler)."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
