"""The stall a just-in-time decode puts before a block's forward pass:
the 95th percentile, over every request the window answered, of the
host-clock time from a unit's decode call to its answer (each unit's
decode ends in a fetch that waits for the card)."""
import statistics


def read(run):
    took = run["window"]["request_s"]
    if len(took) < 2:
        return None
    return 1e3 * statistics.quantiles(took, n=20, method="inclusive")[-1]
