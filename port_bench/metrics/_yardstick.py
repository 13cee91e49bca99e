"""The benchmark's yardstick: the card's published peak, the byte counts
of a container, and the busy share of a traced window.

Byte counts come from the containers themselves (the header's lengths),
so they are the same whatever program wrote or reads them: a decode reads
each container's payload once and writes its original bytes once; an
encode reads the original bytes once and writes the payload once.  The
busy arithmetic (union of device intervals clipped to a span) is the
chip smoke test's ``busy_share``, copied."""
from __future__ import annotations

from typing import Iterable, List, Tuple

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the full 700 W limit
PEAK_HBM_BYTES_PER_S = 3.35e12


def container_sizes(container) -> Tuple[int, int, int]:
    """(header bytes with the shape extension, payload bytes, original
    bytes) of one frame."""
    mv = memoryview(container)
    original = int.from_bytes(mv[16:24], "little")
    head = 32
    if mv[8] in (2, 3, 5):  # tensor formats carry a packed shape
        ndim, i = mv[32], 33
        for _ in range(ndim):
            i += 1 + mv[i]
        head = i
    return head, len(mv) - head, original


def roofline_pct(nbytes: float, seconds: float):
    """Share of the least time, ``nbytes`` at the HBM peak, in
    ``seconds``; None when nothing ran."""
    if not seconds or seconds <= 0 or not nbytes:
        return None
    return 100.0 * (nbytes / PEAK_HBM_BYTES_PER_S) / seconds


def union(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] outside every interval."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return [g for g in out if g[1] > g[0]]
