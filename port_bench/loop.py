"""The closed loop that every driver's window runs, and what drivers share:
the weights' bytes, the container sample and the correctness checks."""
from __future__ import annotations

import gc
import random
import sys
import time
import traceback
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from . import model as model_mod
from .reference import encoder


def stamp(label: str, t0: float) -> None:
    """A set-up phase's end, on standard error: seconds since ``t0``."""
    print(f"setup {label} {time.perf_counter() - t0:.3f}", file=sys.stderr)


def span(name: str):
    """The benchmark's own span around a call, for the trace."""
    return torch.profiler.record_function(f"bench:{name}")


class Window:
    """What a window did: its requests, their bytes and times, its host
    clock."""

    def __init__(self):
        self.requests = 0
        self.failed = 0
        self.bytes = 0  # original (decompressed) bytes of the work done
        self.seconds = 0.0
        self.launches = 0
        self.request_s: List[float] = []  # each answered request, from its call to its answer
        self.marks: List[tuple] = []  # (seconds since the start, original bytes) a request
        self.cpu_s = 0.0  # the process's CPU seconds, all its threads, over the window
        self.gc_s = 0.0  # seconds in Python's garbage collector over the window
        self.gc_runs = [0, 0, 0]  # its collections in the window, by generation

    def tenths(self) -> List[float]:
        """GB/s in each tenth of the window, by when requests ended."""
        out = [0.0] * 10
        for t, b in self.marks:
            out[min(9, int(10 * t / self.seconds))] += b
        return [b / (self.seconds / 10) / 1e9 for b in out]


def run(step: Callable[[int], int], seconds: float, min_requests: int,
        launches: Callable[[], int]) -> Window:
    """Call ``step(n)`` for n = 0, 1, ... (one client: each request after
    the last one's answer) until ``seconds`` have passed and at least
    ``min_requests`` are done.  ``step`` returns the original bytes it
    made usable; a request that raises is counted as failed.  The window
    ends when the last request's answer is in."""
    w = Window()
    gc_t = []

    def on_gc(phase, info):
        if phase == "start":
            gc_t.append(time.perf_counter())
        elif gc_t:
            w.gc_s += time.perf_counter() - gc_t.pop()
            w.gc_runs[info["generation"]] += 1

    gc.callbacks.append(on_gc)
    l0 = launches()
    c0 = time.process_time()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        start = time.perf_counter()
        try:
            nbytes = step(w.requests)
            end = time.perf_counter()
            w.request_s.append(end - start)
            w.marks.append((end - t0, nbytes))
            w.bytes += nbytes
        except Exception:  # a failed request counts; the loop goes on
            traceback.print_exc(file=sys.stderr)
            w.failed += 1
        w.requests += 1
        now = time.perf_counter()
        if now >= deadline and w.requests >= min_requests:
            break
    w.seconds = now - t0
    w.cpu_s = time.process_time() - c0
    w.launches = launches() - l0
    gc.callbacks.remove(on_gc)
    return w


def sample(mdl: model_mod.Model, rng: random.Random, budget: float) -> List[int]:
    """Tensors whose containers the reference checks: a largest one and a
    smallest one, then others in an order drawn from ``rng`` while their
    original bytes stay within ``budget``."""
    sizes = [t.numel for t in mdl.tensors]
    big = rng.choice([i for i, s in enumerate(sizes) if s == max(sizes)])
    small = rng.choice([i for i, s in enumerate(sizes) if s == min(sizes)])
    picked = [big] if big == small else [big, small]
    total = sum(mdl.tensor_bytes(i) for i in picked)
    rest = [i for i in range(len(sizes)) if i not in picked]
    rng.shuffle(rest)
    for i in rest:
        if total + mdl.tensor_bytes(i) <= budget:
            picked.append(i)
            total += mdl.tensor_bytes(i)
    return sorted(picked)


def tensor_bytes_wrong(outs: Sequence, refs: Sequence[torch.Tensor]) -> tuple:
    """(bytes of ``outs`` that differ from ``refs``' bytes, tensors
    missing or of the wrong size)."""
    wrong = missing = 0
    if outs is None or len(outs) != len(refs):
        return 0, len(refs)
    for o, r in zip(outs, refs):
        rb = r.reshape(-1).view(torch.uint8)
        if o is None or o.numel() != rb.numel():
            missing += 1
            continue
        wrong += int((o.reshape(-1) != rb.to(o.device)).sum())
    return wrong, missing


def container_bytes_wrong(got, want: bytes) -> int:
    """Bytes in which container ``got`` differs from ``want``, with the
    difference in length."""
    g = np.frombuffer(got, dtype=np.uint8)
    w = np.frombuffer(want, dtype=np.uint8)
    n = min(g.size, w.size)
    return int(np.count_nonzero(g[:n] != w[:n])) + abs(g.size - w.size)


def reference_containers(mdl: model_mod.Model, flat: torch.Tensor, idx: Sequence[int]) -> Dict[int, bytes]:
    """The reference encoder's container of each tensor of ``idx``, in the
    configuration's profile."""
    out = {}
    for i, t in zip(idx, model_mod.views(mdl, flat, idx)):
        out[i] = encoder.encode(t.reshape(-1).view(torch.uint8), t.shape, mdl.dtype,
                                chunk=mdl.chunk)
    return out


def check_containers(mdl, flat, containers: Dict[int, bytes]) -> int:
    """Summed :func:`container_bytes_wrong` of ``containers`` ({tensor
    index: container}) against the reference's."""
    want = reference_containers(mdl, flat, sorted(containers))
    return sum(container_bytes_wrong(containers[i], want[i]) for i in containers)
