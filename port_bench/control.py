"""The control of the benchmark's correctness check: the plain reference
put in the program's place, computed one precision lower than the
configuration states (bfloat16 weights through float8 e4m3 and back).

    python3 port_bench/control.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py`` does with the control as the system under
test, and prints the same result line: its ``correct`` must be false.
What it replaces is each cell's timed path: a decode returns the rounded
weights' bytes (a fresh copy every request).  The set-up's containers are
still the program's, so only the decoded tensors' comparison can fail.
The benchmark's own runs never run this file.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402

LOWER = {torch.bfloat16: torch.float8_e4m3fn, torch.float16: torch.float8_e4m3fn,
         torch.float32: torch.bfloat16}


def lower(t: torch.Tensor) -> torch.Tensor:
    return t.to(LOWER[t.dtype]).to(t.dtype)


class Control:
    """The reference in the program's place, one precision lower."""

    def __init__(self, device):
        from port_bench.system import Port  # noqa: PLC0415
        self.port = Port(device)  # the set-up's containers only
        self._rounded = {}  # id of a container -> the rounded tensor it stands for

    def launches(self) -> int:
        return 0

    def encode_all(self, tensors, chunk, huffman_table):
        out = self.port.encode_all(tensors, chunk, huffman_table)
        for c, t in zip(out, tensors):
            self._rounded[id(c)] = lower(t)
        return out

    def stage(self, containers):
        return [self._rounded[id(c)] for c in containers]

    def decode(self, staged):
        return [t.reshape(-1).view(torch.uint8).clone() for t in staged]


if __name__ == "__main__":
    argv = sys.argv[1:] + ([] if "--trace" in sys.argv else ["--trace", "0"])
    sys.exit(harness.main(argv, T0, make_system=Control))
