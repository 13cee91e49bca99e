"""A tiny checkout for the harness's CPU tests: ``port_bench`` copied next
to a ``BENCHMARK.json`` whose cell runs a small checkpoint (2 blocks of 5
tensors, chunks of 256 KB, a ragged tail and a norm) through the resident
mix."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "source": "tests only",
    "container": {"dtype": "bfloat16", "chunk": 262144, "huffman_table": "per_chunk"},
    "checkpoint": {
        "head": [["embed", [200, 512]]],
        "layers": [{"first": 0, "count": 2, "tensors": [
            ["l{i}.norm", [512]],
            ["l{i}.q", [256, 512]],
            ["l{i}.up", [520, 512]],
            ["l{i}.experts.{e}", [64, 512]]]}],
        "tail": [["norm", [512]]],
    },
}
TINY["checkpoint"]["layers"][0]["tensors"][3] = {
    "each": "e", "count": 2, "tensors": [["l{i}.experts.{e}", [64, 512]]]}


def run_cell(root, cell, make_system=None, seed=2**31 + 7, trace=0, capsys=None):
    """One CPU run of ``cell`` in the tiny checkout: (exit code, result)."""
    import time  # noqa: PLC0415

    from port_bench import harness  # noqa: PLC0415

    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
                       "--trace", str(trace)], time.perf_counter(), device="cpu",
                      make_system=make_system, root=root)
    out = capsys.readouterr().out.strip().splitlines() if capsys else []
    return rc, (json.loads(out[-1]) if out else None)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout root holding a copy of ``port_bench`` and a benchmark
    whose one cell runs the resident mix on the tiny checkpoint, with
    every metric of the real benchmark."""
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "port_bench" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "tests", "file": "port_bench/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": "tiny.resident", "config": "tiny", "traffic": "resident",
                           "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.resident"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
