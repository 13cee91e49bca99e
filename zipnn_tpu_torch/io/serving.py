"""Back-to-back shard decode for serving loads.

The decode half of the JAX package's ``io/serving.py``.  A model load
decompresses many containers in a row (one per tensor in the per-tensor
safetensors schema); one ``ZipNN.decompress`` at a time pays each
container's host plan, uploads and validation fetch in turn.  This module
overlaps them on the card:

* ``decode.start`` of container N+1 (its host plan, its copies into
  pinned memory and their DMA on the copy stream, its kernels queued
  behind them) runs while container N's kernels run; ``finish`` then
  fetches container N's ``bits_left``;
* :meth:`ShardDecoder.stage` does the plan and every upload ahead of
  time, so :meth:`ShardDecoder.start_staged` only queues kernels;
* :meth:`ShardDecoder.decompress_all` defers every container's
  end-of-stream check to one fetch for the whole load.

Usage::

    from zipnn_tpu_torch.io.serving import ShardDecoder
    dec = ShardDecoder(to_device=True)          # uint8 CUDA tensors
    for out in dec.decompress_iter(blobs):
        ...

Containers may be byte-format frames or torch/numpy-format frames (with a
shape after the header); the decoder always yields the flat decompressed
bytes, and the caller reapplies dtype and shape.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from .. import codec
from ..core import dtypes
from ..core.header import HEADER_LEN, Header
from ..ops import decode
from ..zipnn import check_ported

__all__ = ["ShardDecoder", "decompress_iter"]


class _Started:
    """In-flight container: its kernels queued, ``finish()`` drains."""

    __slots__ = ("finish", "out", "hdr")

    def __init__(self, finish, out, hdr):
        self.finish = finish
        self.out = out
        self.hdr = hdr


class _StagedShard:
    """A staged container: its header, its ``decode.Staged`` (plan and
    every device input uploaded) and the bytes those inputs hold."""

    __slots__ = ("hdr", "staged", "upload_bytes")

    def __init__(self, hdr, staged, upload_bytes):
        self.hdr, self.staged, self.upload_bytes = hdr, staged, upload_bytes


class _Stack:
    """Staged shards that :meth:`ShardDecoder.decompress_stacked` runs
    back to back, with one deferred validation."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = list(shards)


class ShardDecoder:
    """Cross-container pipelined decoder on ``device`` (the card unless the
    caller passes ``device="cpu"``, where the kernels' plain versions run).

    ``to_device=True`` yields a uint8 tensor on ``device`` per container,
    the view ``decode.finish`` returns (retype it with ``.view(dtype)``);
    otherwise ``bytes``, or owned writable uint8 numpy arrays under
    ``as_numpy``, decoded on ``device`` and fetched.

    Every container decodes on ``device``, including those with no full
    chunk (a norm weight); there is no host route.  Delta containers raise
    ``ValueError`` as the reference's do.  Streaming, lossy and
    whole-buffer (vanilla method) containers raise the
    ``NotImplementedError`` of the port's ``ZipNN`` until those modes are
    ported.  ``timings`` holds the phase seconds (``plan_s``, ``stage_s``,
    ``upload_s``; see ``decode.last_timings``) of each container of the
    last call, in order.
    """

    def __init__(self, to_device: bool = False, as_numpy: bool = False, device="cuda"):
        self.to_device = to_device
        self.as_numpy = as_numpy
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ShardDecoder with device='cuda' needs a CUDA device; pass "
                "device='cpu' to run the kernels' plain versions")
        self.timings: List[dict] = []

    # -- per-container phases ------------------------------------------
    def _plan_container(self, data):
        """Parse one container's header; returns (header, the arguments of
        ``decode.start`` / ``decode.stage`` but ``device``)."""
        mv = memoryview(data)
        if len(mv) < HEADER_LEN or bytes(mv[0:2]) != b"ZN":
            raise ValueError("Header should start with ZN")
        # torch/numpy frames carry a packed shape after the 32-byte header;
        # ``consumed`` skips it, so the payload slice is format-independent
        hdr, consumed = Header.from_bytes(mv)
        if hdr.delta_mode:
            raise ValueError(
                "delta containers need delta_second_data; use ZipNN.decompress"
            )
        check_ported(hdr)
        total = hdr.total_len if 0 < hdr.total_len <= len(mv) else len(mv)
        num_buf = dtypes.groups_for_decompress(hdr.dtype_code)
        chunk = codec.effective_chunk(hdr.compression_chunk, num_buf)
        return hdr, (mv[consumed:total], num_buf, hdr.bit_reorder, hdr.byte_reorder,
                     chunk, hdr.original_len)

    def _finisher(self, run):
        self.timings.append(run.timings)
        return lambda: self._marshal(decode.finish(run))

    def start(self, data, defer=None) -> _Started:
        """Host plan, uploads and kernel launches of one container; the
        handle's ``finish()`` yields its output.  ``defer`` (a list) skips
        the container's validation fetch: see :meth:`decompress_all`."""
        hdr, args = self._plan_container(data)
        run = decode.start(*args, device=self.device, defer=defer)
        return _Started(self._finisher(run), run.out, hdr)

    def stage(self, data) -> _StagedShard:
        """Parse, plan and upload every device input of one container, for
        :meth:`start_staged`, which copies nothing to the card."""
        hdr, args = self._plan_container(data)
        st = decode.stage(*args, device=self.device)
        return _StagedShard(hdr, st, st.inputs.nbytes if st.inputs else 0)

    def start_staged(self, st: _StagedShard, defer=None) -> _Started:
        """Queue the kernels of a :meth:`stage`\\ d container (any number of
        times)."""
        run = decode.start_staged(st.staged, defer=defer)
        return _Started(self._finisher(run), run.out, st.hdr)

    def _marshal(self, flat: torch.Tensor):
        if self.to_device:
            return flat
        host = np.empty(flat.numel(), dtype=np.uint8)
        torch.from_numpy(host).copy_(flat)
        return host if self.as_numpy else host.tobytes()

    # -- pipelined iteration --------------------------------------------
    def decompress_iter(self, blobs: Iterable, depth: int = 2) -> Iterator:
        """Decode ``blobs`` in order, keeping up to ``depth`` containers in
        flight: container N+1's plan, uploads and launches overlap
        container N's kernels."""
        self.timings = []
        inflight: List[_Started] = []
        for blob in blobs:
            inflight.append(self.start(blob))
            if len(inflight) >= depth:
                yield inflight.pop(0).finish()
        while inflight:
            yield inflight.pop(0).finish()

    def decompress(self, data):
        """Single-container convenience (no pipelining)."""
        self.timings = []
        return self.start(data).finish()

    # -- staged bundles --------------------------------------------------
    def stack(self, staged_list) -> Optional[_Stack]:
        """Bundle staged shards for :meth:`decompress_stacked`; None when
        one of them is not a :meth:`stage` handle."""
        if not all(isinstance(s, _StagedShard) for s in staged_list):
            return None
        return _Stack(staged_list)

    def _need_owned_output(self, what: str) -> None:
        if not (self.to_device or self.as_numpy):
            raise ValueError(f"{what} needs to_device=True or as_numpy=True")

    def decompress_stacked(self, stk_or_list) -> Optional[list]:
        """Decode a :meth:`stack` bundle (or stack a staged list inline):
        its shards' staged launches back to back, validated by one fetch;
        returns per-shard outputs in order, or None when not stackable."""
        self._need_owned_output("decompress_stacked")
        stk = stk_or_list
        if isinstance(stk, (list, tuple)):
            stk = self.stack(stk)
        if stk is None:
            return None
        self.timings = []
        defer: list = []
        outs = [self.start_staged(s, defer=defer).finish() for s in stk.shards]
        self._validate_deferred([defer])
        return outs

    # -- bulk decode with deferred validation ----------------------------
    def decompress_all(self, items, depth: int = 4) -> list:
        """Decode many containers, validating all of them in one fetch at
        the end: every container's kernels run back to back.  ``items`` may
        mix bytes-like containers and :meth:`stage` handles.  Needs device
        or numpy output (``to_device`` / ``as_numpy``), as the reference's
        does."""
        self._need_owned_output("decompress_all")
        return self.decompress_groups(self.stack_groups(items), depth=depth)

    def stack_groups(self, items) -> list:
        """Group ``items`` into execution units: each run of two or more
        consecutive :meth:`stage` handles is one bundle, anything else a
        unit of its own.  The list replays through
        :meth:`decompress_groups` any number of times; its staged units
        copy nothing to the card again."""
        items = list(items)
        units: list = []
        i = 0
        while i < len(items):
            j = i
            while j < len(items) and isinstance(items[j], _StagedShard):
                j += 1
            if j - i >= 2:
                units.append(("stk", _Stack(items[i:j]), list(range(i, j))))
                i = j
                continue
            units.append(("one", items[i], i))
            i += 1
        units.append(("n", len(items)))
        return units

    def decompress_groups(self, units, depth: int = 4) -> list:
        """Execute a :meth:`stack_groups` plan: launches, up to ``depth``
        containers in flight, and one validation fetch."""
        self._need_owned_output("decompress_groups")
        self.timings = []
        n = units[-1][1]
        defers: list = [[] for _ in range(n)]
        outs: list = [None] * n
        inflight: list = []
        for unit in units[:-1]:
            if unit[0] == "stk":
                _kind, stk, idxs = unit
                for s, gi in zip(stk.shards, idxs):
                    outs[gi] = self.start_staged(s, defer=defers[gi]).finish()
                continue
            _kind, it, i = unit
            if isinstance(it, _StagedShard):
                inflight.append((i, self.start_staged(it, defer=defers[i])))
            else:
                inflight.append((i, self.start(it, defer=defers[i])))
            if len(inflight) >= depth:
                j, h = inflight.pop(0)
                outs[j] = h.finish()
        while inflight:
            j, h = inflight.pop(0)
            outs[j] = h.finish()
        self._validate_deferred(defers)
        return outs

    def _validate_deferred(self, defers) -> None:
        """One fetch of every deferred container's ``bits_left`` (in order:
        the first bad container raises its own ``CorruptChunkError``); the
        fetch follows every launch on the compute stream, so the outputs
        are complete when it returns."""
        decode.validate_deferred([e for d in defers for e in d])


def decompress_iter(blobs: Iterable, to_device: bool = False, device="cuda") -> Iterator:
    """Module-level convenience: ``ShardDecoder(to_device, device=device)
    .decompress_iter``."""
    return ShardDecoder(to_device=to_device, device=device).decompress_iter(blobs)
