"""Decode kernels' share of their HBM roofline in a traced resident
decode: each container's payload read once and its original bytes
written once, at the card's peak, over the device time of all kernels in
the traced window."""
from port_bench.metrics import _yardstick as ys


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    return ys.roofline_pct(tr["payload_bytes"] + tr["bytes"], tr["kernel_s"])
