"""CPU tests of ``port_bench/spans.py`` and of ``tracing.reduce`` on a
synthetic trace: a window of 100 us holding one resident unit (two
enqueues, each with its allocation, then the validation and its fetch)
and four device intervals, one of them past the window's end."""
from __future__ import annotations

import json

import pytest
import torch

from port_bench import control, spans, tracing


def _x(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


EVENTS = [
    _x("bench:window", 0, 100), _x("znn:decode:plan", -10, 5),
    _x("bench:decode_unit", 10, 80), _x("znn:decode:stacked", 12, 76),
    _x("znn:decode:enqueue", 14, 16), _x("znn:decode:alloc", 15, 2),
    _x("znn:decode:enqueue", 32, 18), _x("znn:decode:alloc", 33, 3),
    _x("znn:decode:validate", 60, 20), _x("znn:decode:bits_fetch", 61, 9),
    _x("k1", 20, 20, "kernel", 7), _x("k2", 41, 4, "kernel", 7),
    _x("Memcpy DtoH", 70, 1, "gpu_memcpy", 7), _x("k1", 98, 7, "kernel", 7),
    _x("cudaLaunchKernel", 21, 1, "cuda_runtime"), _x("aten::empty", 15.5, 1, "cpu_op"),
    {"ph": "i", "name": "marker", "ts": 3},
]


def test_reduce_keeps_its_values():
    """``tracing.reduce``'s result on the synthetic trace, as written before
    ``spans.py`` existed."""
    assert tracing.reduce(EVENTS) == {
        "window_s": 0.0001, "busy_s": 2.7e-05, "kernel_s": 2.6e-05,
        "device_ops": [["k1", 2.2000000000000003e-05], ["k2", 4e-06], ["Memcpy DtoH", 1e-06]],
        "idle_gaps": [["znn:decode:validate", 2.7e-05],
                      ["znn:decode:enqueue", 2.6000000000000002e-05], ["bench:window", 2e-05]]}


def test_span_seconds_count_total_and_self():
    got = spans.span_s(EVENTS)
    want = {"znn:decode:stacked": [1, 76, 76 - 16 - 18 - 20], "znn:decode:enqueue": [2, 34, 29],
            "znn:decode:alloc": [2, 5, 5], "znn:decode:validate": [1, 20, 11],
            "znn:decode:bits_fetch": [1, 9, 9]}  # us; the plan before the window is left out
    assert set(got) == set(want)
    for name, (n, total, own) in want.items():
        assert got[name][0] == n and got[name][1:] == pytest.approx([total / 1e6, own / 1e6])
    assert spans.span_s([e for e in EVENTS if e["name"] != "bench:window"]) is None


def test_idle_is_split_instant_by_instant():
    """The stretch 45-70 us crosses the end of an enqueue, the stacked
    span's glue, the validation and its fetch: each gets its part."""
    got = spans.idle_by_span(EVENTS)
    want = {"bench:window": 18, "bench:decode_unit": 4, "znn:decode:stacked": 20,
            "znn:decode:enqueue": 10, "znn:decode:alloc": 2, "znn:decode:validate": 10,
            "znn:decode:bits_fetch": 9}
    assert got == pytest.approx({k: v / 1e6 for k, v in want.items()})
    r = tracing.reduce(EVENTS)
    assert sum(got.values()) == pytest.approx(r["window_s"] - r["busy_s"])
    assert sum(v for _, v in r["idle_gaps"]) == pytest.approx(r["window_s"] - r["busy_s"])


def test_metrics_read_the_spans_and_nothing_without_them():
    m = spans.metrics(spans.span_s(EVENTS), spans.idle_by_span(EVENTS), 1e-4)
    assert m == pytest.approx({"enqueue_us_per_container.resident": 17.0,
                               "alloc_us_per_container.resident": 2.5,
                               "idle_enqueue.resident": 12.0, "idle_validate.resident": 19.0})
    bare = [e for e in EVENTS if not e["name"].startswith("znn:")]
    assert spans.metrics(spans.span_s(bare), spans.idle_by_span(bare), 1e-4) == {}
    assert spans.metrics(None, None, 0.0) == {}


class Spanned(control.Control):
    """A cheap system that opens the resident path's spans as the program
    does: the stacked call, an enqueue holding an allocation a tensor,
    the validation holding its fetch."""

    def decode(self, staged):
        rf = torch.profiler.record_function
        with rf("znn:decode:stacked"):
            outs = []
            for t in staged:
                with rf("znn:decode:enqueue"), rf("znn:decode:alloc"):
                    outs.append(t.reshape(-1).view(torch.uint8).clone())
            with rf("znn:decode:validate"), rf("znn:decode:bits_fetch"):
                pass
        return outs


def test_a_traced_run_with_spans_on_the_cpu(tiny_root, capsys):
    """The harness's traced run with the spans added, on the CPU (no
    device events, so the whole window is idle): the run's own result
    line keeps its form, ``tracing.reduce`` is itself again after it, and
    the four readings are there."""
    rc = spans.main(["--workload", "tiny.resident", "--seed", str(2**31 + 9), "--seconds", "0.2"],
                    device="cpu", make_system=Spanned, root=tiny_root)
    lines = capsys.readouterr().out.strip().splitlines()
    res, got = json.loads(lines[-2]), json.loads(lines[-1])
    assert rc == 0 and set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert tracing.reduce.__module__ == "port_bench.tracing"
    assert set(got["metrics"]) == {"enqueue_us_per_container.resident",
                                   "alloc_us_per_container.resident", "idle_enqueue.resident",
                                   "idle_validate.resident"}
    n = got["span_s"]["znn:decode:enqueue"][0]
    assert n == got["span_s"]["znn:decode:alloc"][0] == 2 * 12  # 2 traced cycles of 12 tensors
    assert sum(got["idle_by_span"].values()) == pytest.approx(got["window_s"] - got["busy_s"])
    assert sum(got["metrics"][k] for k in ("idle_enqueue.resident", "idle_validate.resident")) < 100
