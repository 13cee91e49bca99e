"""Resident decode: the checkpoint's containers staged in the card's
memory at set-up; one client decodes the model unit by unit, in order
(each block, then the tensors outside the blocks), cycling until the
window closes.  Each unit is one staged decode checked by one fetch.

Kept for the check: each unit's output of the last cycle, and of cycle 0
or 1 (drawn from the seed).  Every request's outputs are also held to
owning new memory: while a unit decodes, its output of the cycle before
is still kept, so a request whose outputs share storage with it handed
back old tensors instead of decoding (``outputs_reused``)."""
from __future__ import annotations

import time

from .. import loop
from .. import model as model_mod
from ..metrics import _yardstick as ys


def _storages(outs) -> set:
    return {o.untyped_storage().data_ptr() for o in outs if o is not None and o.numel()}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.m = ctx.model
        self.sys = ctx.system
        self.units = self.m.units
        self.early = [ctx.rng.randrange(2) for _ in self.units]
        self.kept = {}  # (unit, "early" | "last") -> outputs
        self.last_storages = {}  # unit -> storages of its "last" outputs
        self.reused = 0  # storages shared with the unit's outputs of the cycle before

    def setup(self) -> None:
        t0 = time.perf_counter()
        flat = model_mod.weights(self.m, self.ctx.seed, self.ctx.device)
        self.containers = self.sys.encode_all(model_mod.views(self.m, flat), self.m.chunk,
                                              self.m.huffman_table)
        del flat
        loop.stamp("weights+encode", t0)
        self.staged = [self.sys.stage([self.containers[i] for i in u]) for u in self.units]
        loop.stamp("stage", t0)
        self.unit_bytes = [sum(self.m.tensor_bytes(i) for i in u) for u in self.units]
        self.unit_pbytes = [sum(ys.container_sizes(self.containers[i])[1] for i in u)
                            for u in self.units]
        # every shape of the window, and as many outputs alive at once as
        # the window keeps (two cycles and the unit in flight), so the
        # allocator's cache holds every block the window asks for
        held = [self.sys.decode(s) for _ in range(3) for s in self.staged]
        del held
        loop.stamp("warm-up", t0)

    def _step(self, n: int) -> int:
        u, cycle = n % len(self.units), n // len(self.units)
        outs = self.sys.decode(self.staged[u])
        mine = _storages(outs)
        self.reused += len(mine & self.last_storages.get(u, set()))
        self.last_storages[u] = mine
        self.kept[(u, "last")] = outs
        if cycle == self.early[u]:
            self.kept[(u, "early")] = outs
        return self.unit_bytes[u]

    def window(self, seconds: float) -> loop.Window:
        return loop.run(self._step, seconds, 2 * len(self.units), self.sys.launches)

    def traced(self) -> dict:
        cycles = self.ctx.params["trace_cycles"]
        for u in range(len(self.units) * cycles):
            with loop.span("decode_unit"):
                self.sys.decode(self.staged[u % len(self.units)])
        return {"bytes": sum(self.unit_bytes) * cycles,
                "payload_bytes": sum(self.unit_pbytes) * cycles}

    def release(self) -> None:
        self.staged = None

    def check(self) -> dict:
        flat = model_mod.weights(self.m, self.ctx.seed, self.ctx.device)
        wrong = missing = 0
        for (u, _), outs in self.kept.items():
            w, mi = loop.tensor_bytes_wrong(outs, model_mod.views(self.m, flat, self.units[u]))
            wrong += w
            missing += mi
        missing += sum(2 for u in range(len(self.units))
                       if (u, "early") not in self.kept or (u, "last") not in self.kept)
        self.kept = {}
        idx = loop.sample(self.m, self.ctx.rng, self.ctx.params["check_bytes"])
        cwrong = loop.check_containers(self.m, flat, {i: self.containers[i] for i in idx})
        return {"tensor_bytes_wrong": wrong, "tensors_missing": missing,
                "outputs_reused": self.reused, "container_bytes_wrong": cwrong}
