"""K2's (``combine_cells``) share of its HBM roofline in a traced resident
decode: each original byte read once (from a stored cell or a decoded
symbol row) and written once, ``2 * bytes`` at the card's peak, over the
device seconds of the kernels whose name holds ``combine_cells``.

The bytes are the run's own count of what the traced cycles decoded, so
the yardstick is the same whatever implements K2.  An RLE cell reads
nothing, so its bytes are counted once too many; fp32 weights have few."""
from port_bench.metrics import _yardstick as ys

KERNEL = "combine_cells"


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    seconds = sum(s for name, s in tr["device_ops"] if KERNEL in name)
    return ys.roofline_pct(2 * tr["bytes"], seconds)
