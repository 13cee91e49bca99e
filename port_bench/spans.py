"""The program's spans in a traced run: what each ``znn:*`` span costs on
the host, and which span the card's idle time falls in.

:func:`span_s` and :func:`idle_by_span` reduce the same Chrome trace
events as ``tracing.reduce``; :func:`metrics` turns them into the serving
layer's four readings of the resident path.  ``tracing.reduce`` does not
call them yet: run as a script, this file runs one traced run of a cell
through the harness with them added, and prints their result as one JSON
line after the run's own result line:

    python3 port_bench/spans.py --workload <cell> --seed <n> --seconds <s>
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench.metrics import _yardstick as ys  # noqa: E402
from port_bench.tracing import DEVICE_CATS, WINDOW  # noqa: E402

ENQUEUE = ("znn:decode:enqueue", "znn:decode:alloc")
VALIDATE = ("znn:decode:validate", "znn:decode:bits_fetch")


def _window(xs):
    win = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    return (win[0]["ts"], win[0]["ts"] + win[0]["dur"]) if win else None


def _spans(xs):
    """(start, end, name, thread) of every ``znn:*`` and ``bench:*`` span."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"], (e.get("pid"), e.get("tid"))) for e in xs
            if e.get("cat") == "user_annotation"
            and (e["name"].startswith("znn:") or e["name"].startswith("bench:"))]


def span_s(events) -> dict:
    """For each ``znn:*`` span that starts inside the window: [count, total
    seconds, self seconds], self being its time outside the ``znn:*`` and
    ``bench:*`` spans nested in it on its thread; None without a window."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = _window(xs)
    if win is None:
        return None
    lo, hi = win
    out = defaultdict(lambda: [0, 0.0, 0.0])
    by_thread = defaultdict(list)
    for s in _spans(xs):
        by_thread[s[3]].append(s)
    for spans in by_thread.values():
        # spans of one thread nest: a stack, each span's children
        # subtracted from its self time as they close
        stack = []  # [end, name, counted, child seconds]

        def close(top):
            if top[2]:
                out[top[1]][2] -= top[3]

        for a, b, name, _ in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][0] <= a:
                close(stack.pop())
            if stack:
                stack[-1][3] += (b - a) / 1e6
            counted = name.startswith("znn:") and lo <= a < hi
            if counted:
                row = out[name]
                row[0] += 1
                row[1] += (b - a) / 1e6
                row[2] += (b - a) / 1e6
            stack.append([b, name, counted, 0.0])
        while stack:
            close(stack.pop())
    return {k: v for k, v in sorted(out.items())}


def idle_by_span(events) -> dict:
    """Seconds of the window in which the card ran no kernel and no copy,
    each instant given to the innermost ``znn:*`` or ``bench:*`` span open
    then (``bench:window`` where none is): its values sum to the window's
    idle time.  None without a window."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = _window(xs)
    if win is None:
        return None
    lo, hi = win
    idle = ys.gaps([(e["ts"], e["ts"] + e["dur"]) for e in xs if e.get("cat") in DEVICE_CATS],
                   lo, hi)
    spans = _spans(xs)
    marks = sorted([(a, 1, i) for i, (a, *_) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, b, *_) in enumerate(spans)])
    out = defaultdict(float)
    stack, k, g, t = [], 0, 0, lo
    while t < hi and g < len(idle):
        while k < len(marks) and marks[k][0] <= t:
            _, is_start, i = marks[k]
            if is_start:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            k += 1
        nxt = min(marks[k][0] if k < len(marks) else hi, hi)
        name = spans[stack[-1]][2] if stack else WINDOW
        while g < len(idle) and idle[g][0] < nxt:  # idle stretches meeting [t, nxt)
            a, b = max(idle[g][0], t), min(idle[g][1], nxt)
            if b > a:
                out[name] += (b - a) / 1e6
            if idle[g][1] > nxt:
                break
            g += 1
        t = nxt
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def metrics(span: dict, idle: dict, window_s: float) -> dict:
    """The serving layer's readings of a traced resident run, each left out
    when its spans are absent: host microseconds a container in the
    enqueue and in the output allocation, and the window's share (%) in
    which the card idles while the host enqueues, or validates."""
    out = {}
    for key, name in (("enqueue_us_per_container.resident", ENQUEUE[0]),
                      ("alloc_us_per_container.resident", ENQUEUE[1])):
        if span and span.get(name, [0])[0]:
            out[key] = 1e6 * span[name][1] / span[name][0]
    for key, names in (("idle_enqueue.resident", ENQUEUE), ("idle_validate.resident", VALIDATE)):
        if span and any(n in span for n in names) and window_s:
            out[key] = 100.0 * sum(idle.get(n, 0.0) for n in names) / window_s
    return out


def main(argv, **kw) -> int:
    """``harness.main`` with ``--trace 1`` and this file's reductions added
    to the trace (``kw``: its ``device``, ``make_system`` and ``root``)."""
    from port_bench import harness, tracing  # noqa: PLC0415

    plain, got = tracing.reduce, {}

    def reduce(events):
        out = plain(events)
        if out is not None:
            got.update(window_s=out["window_s"], busy_s=out["busy_s"],
                       span_s=span_s(events), idle_by_span=idle_by_span(events))
        return out

    tracing.reduce = reduce
    try:
        rc = harness.main(list(argv) + ["--trace", "1"], T0, **kw)
    finally:
        tracing.reduce = plain
    if got:
        got["metrics"] = metrics(got["span_s"], got["idle_by_span"], got["window_s"])
    print(json.dumps(got))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
