"""The correctness check fails what it must: runs of the tiny cells on
the CPU with the timed path broken underneath the harness (each fault a
cell can have, and a decode that hands back the tensors of an
earlier request), and with the control (the reference one precision lower
in the program's place).  The exchange between chips is no fault here:
every cell runs on one card."""
from __future__ import annotations

import pytest
import torch

from port_bench import control
from port_bench.system import Port

from .conftest import run_cell


class Faulty(Port):
    """The program with one fault planted where its answers are made."""

    fault = None

    def decode(self, staged):
        if self.fault == "cached":  # each unit decoded once, then handed back again
            cache = self.__dict__.setdefault("_cache", {})
            if id(staged) not in cache:
                cache[id(staged)] = super().decode(staged)
            return cache[id(staged)]
        outs = super().decode(staged)
        if self.fault == "unchanged":  # the output buffers never written
            return [torch.zeros_like(o) for o in outs]
        if self.fault == "half":  # half of the batch left out
            return outs[: len(outs) // 2] + [None] * (len(outs) - len(outs) // 2)
        outs[0][0] ^= 1  # an answer altered where it is produced
        return outs


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "cached"])
def test_fault_is_not_correct(tiny_root, fault, capsys):
    make = type("F", (Faulty,), {"fault": fault})
    rc, res = run_cell(tiny_root, "tiny.resident", make_system=make, capsys=capsys)
    assert rc == 0 and res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values()) or res["failed"]
    if fault == "cached":
        assert res["checks"]["outputs_reused"]["value"] > 0


def test_control_is_not_correct(tiny_root, capsys):
    rc, res = run_cell(tiny_root, "tiny.resident", make_system=control.Control, capsys=capsys)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["tensor_bytes_wrong"]["value"] > 0
