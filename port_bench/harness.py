"""One run of one cell of the port's benchmark.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (``configs/``), its traffic mix (``traffic/<name>.json``,
whose ``driver`` names ``drivers/<driver>.py``) and each metric's reader
(``metrics/<metric>.py``, a function ``read(run)`` that returns a number
or None when it finds nothing to read).  A run: set-up (weights from the
seed, the mix's own set-up, a warm-up of every shape), the window, with
``--trace 1`` a traced stretch after it, then the checks of what the
window produced against the plain reference.  The last line of standard
output is the result; the numbers compared, each with its limit, are the
last lines of standard error and the result's last key.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import random
import sys
import threading
import time
from pathlib import Path

import torch

from . import model as model_mod
from . import tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "zipnn_tpu")
LIMIT = 0  # every comparison is exact: no byte may differ


class Context:
    def __init__(self, system, model, params, seed, device):
        self.system, self.model, self.params = system, model, params
        self.seed, self.device = seed, device
        self.rng = random.Random(seed)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration file, mix file and driver file,
    and its metrics (end-to-end and per-layer) with their readers' files,
    under the checkout ``root``."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return workload in m.get("workloads", [workload])

    pb = root / HERE.name
    mix_file = pb / "traffic" / f"{cell['traffic']}.json"
    driver = json.loads(mix_file.read_text())["driver"]
    return {
        "cell": cell,
        "config_file": root / cfg["file"],
        "mix_file": mix_file,
        "driver_file": pb / "drivers" / f"{driver}.py",
        "end_to_end": [dict(m, file=pb / "metrics" / f"{m['name']}.py")
                       for m in bench["end_to_end"] if mine(m)],
        "per_layer": [dict(m, file=pb / "metrics" / f"{m['name']}.py")
                      for m in bench["per_layer"] if mine(m)],
    }


def banned_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in BANNED)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float, device=None, make_system=None, root: Path = ROOT) -> int:
    """Run a cell; returns the exit code.  ``device``, ``make_system`` and
    ``root`` are for the tests: a CPU device skips the look for a card,
    ``make_system(device)`` stands in for the program, and
    ``root`` is another checkout's root."""
    args = parse(argv)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    spec = resolve(bench, args.workload, root)
    chips = spec["cell"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    params = json.loads(spec["mix_file"].read_text())
    if make_system is None:
        from .system import Port  # noqa: PLC0415
        make_system = Port
    mdl = model_mod.load(spec["config_file"])
    ctx = Context(make_system(device), mdl, params, args.seed, device)
    driver = _load(spec["driver_file"], f"port_bench.drivers.{params['driver']}").Driver(ctx)

    if device.type == "cuda":
        torch.cuda.init()
    print(f"setup start {time.perf_counter() - t0:.3f}", file=sys.stderr)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # what set-up made lives on through the window: kept out of the
    # collector's full scans, as a long-running server keeps its start-up
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    window = driver.window(args.seconds)
    took = sorted(window.request_s) or [0.0]
    print(f"window {window.requests} requests {window.seconds:.3f} s; request s min "
          f"{took[0]:.4f} median {took[len(took) // 2]:.4f} max {took[-1]:.4f}; GB/s by tenths "
          + " ".join(f"{r:.3f}" for r in window.tenths()), file=sys.stderr)
    print(f"window host: cpu {window.cpu_s:.3f} s over {window.seconds:.3f} s; gc {window.gc_s:.4f} s "
          f"in {window.gc_runs} collections by generation; python threads "
          f"{threading.active_count()}, torch threads {torch.get_num_threads()}", file=sys.stderr)
    trace = None
    if args.trace:
        with tracing.capture() as cap:
            done = driver.traced()
        trace = dict(cap.summary or {}, **done) if cap.summary else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = banned_modules()
    if found:
        print(f"modules that the port must not load are loaded: {found}", file=sys.stderr)
        return 3

    driver.release()
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    checks = driver.check()
    print(f"checked in {time.perf_counter() - t1:.3f} s", file=sys.stderr)

    run = {"setup_s": setup_s, "window": {k: v for k, v in vars(window).items() if k != "marks"}, "trace": trace, "params": params}
    wanted = spec["per_layer"] if args.trace else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        value = _load(m["file"], f"port_bench_metric_{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    if trace:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    result = {"correct": window.failed == 0 and all(v <= LIMIT for v in checks.values()),
              "attempted": window.requests, "failed": window.failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": LIMIT} for k, v in checks.items()}
    found = banned_modules()
    if found:
        print(f"modules that the port must not load are loaded: {found}", file=sys.stderr)
        return 3
    for k, v in checks.items():
        print(f"check {k} {v} limit {LIMIT}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
