"""Kernel launches per GB decoded over the resident window (the
program's launch counters): what batching containers would cut."""


def read(run):
    w = run["window"]
    return w["launches"] / (w["bytes"] / 1e9) if w["bytes"] else None
