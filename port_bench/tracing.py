"""A traced stretch of a run: ``torch.profiler`` over the card's kernels
and copies and the host's spans, reduced to what the per-layer metrics
and the breakdown read.

The trace goes to a temporary directory under ``TMPDIR`` as Chrome JSON
and is read back and deleted.  Device work is every ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` event; the window is the benchmark's
own ``bench:window`` span; an idle stretch of the card is named by the
innermost host span (a ``znn:*`` span of the program, else the
benchmark's own ``bench:*``) open where the stretch begins."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch

from .metrics import _yardstick as ys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench:window"


class Capture:
    def __init__(self):
        self.summary = None


@contextlib.contextmanager
def capture():
    """Profile the block; ``.summary`` holds :func:`reduce`'s result after
    it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    cap = Capture()
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                yield cap
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    cap.summary = reduce(events)


def reduce(events) -> dict:
    """Seconds of the window, of device work in it (kernels and copies;
    kernels alone), device seconds by kernel name, and idle seconds by the
    host span open when each idle stretch began."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not win:
        return None
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"], e["cat"]) for e in xs
           if e.get("cat") in DEVICE_CATS]
    busy = ys.union([(a, b) for a, b, _, _ in dev], lo, hi)
    kern = ys.union([(a, b) for a, b, _, c in dev if c == "kernel"], lo, hi)
    by_name = defaultdict(float)
    for a, b, name, _ in dev:
        if b > lo and a < hi:
            by_name[name] += (min(b, hi) - max(a, lo)) / 1e6
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
             if e.get("cat") == "user_annotation"
             and (e["name"].startswith("znn:") or e["name"].startswith("bench:"))]
    idle = defaultdict(float)
    stretches = ys.gaps([(x, y) for x, y, _, _ in dev], lo, hi)
    for (a, b), name in zip(stretches, _innermost(spans, stretches)):
        idle[name] += (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6, "kernel_s": kern / 1e6,
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def _innermost(spans, stretches):
    """For each stretch (in time order), the name of the innermost span
    open at its start: a sweep over the spans' starts and ends."""
    marks = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    stack, k, out = [], 0, []
    for a, _ in stretches:
        while k < len(marks) and marks[k][0] <= a:
            _, is_start, i = marks[k]
            if is_start:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            k += 1
        out.append(spans[stack[-1]][2] if stack else WINDOW)
    return out
