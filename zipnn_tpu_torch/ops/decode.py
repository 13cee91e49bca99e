"""Decompress a reference-profile container straight into device memory.

The counterpart of the JAX package's ``ops/jax_decode.py`` for containers
with per-chunk Huffman tables (what the reference library writes):

1. **Host plan** (:class:`Geometry`, :class:`Plan`): parse the chunk
   tables, classify every (plane, chunk) cell as stored, RLE or Huffman —
   the ragged tail chunk included — slice every Huffman cell's header and
   jump table vectorised, and parse each cell's decode table once.
2. **One upload** of the payload bytes, the per-stream arrays and the
   tables.
3. **Chunk-range batches**: per batch, kernel K1 (``huf_pc.huf_pc_decode``)
   decodes the batch's Huffman streams into symbol rows, then kernel K2
   (``combine.combine_cells``) assembles the batch's chunks into the
   output buffer in place.
4. **End-of-stream check**: every stream must end with ``bits_left == 0``;
   the first that does not raises ``CorruptChunkError(plane, chunk,
   stream)``.

On CPU tensors the kernels' plain versions run, so the same pipeline
decodes on the host for the tests.  Shared-table containers and fp32 (4
planes) are later slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from .. import codec
from ..errors import CorruptChunkError
from . import combine, huf_pc

KIND_STORED, KIND_RLE, KIND_HUF = 0, 1, 2
SHARED_TLOG_MAX = 8  # the shared-table profile's table limit
BATCH_BYTES = 512 << 20  # output bytes per device batch

# what the last decompress_payload call spent, for callers that report it:
# plan_s / upload_s (host clock), and on CUDA the K1 / K2 event pairs
last_timings: Dict = {}


class Geometry:
    """Chunk tables and the per-cell classification of one container."""

    def __init__(self, payload, num_buf, chunk_size, orig_size, bit_reorder,
                 byte_reorder):
        self.payload_np = np.frombuffer(memoryview(payload), dtype=np.uint8)
        self.num_buf = num_buf
        self.chunk_size = chunk_size
        self.orig_size = orig_size
        self.bit_reorder = bit_reorder
        self.byte_reorder = byte_reorder
        self.n_chunks = codec.num_chunks_for(orig_size, chunk_size)
        types, starts, data_start = codec.parse_tables(
            payload, num_buf, self.n_chunks
        )
        plane_base = np.zeros(num_buf, dtype=np.int64)
        for b in range(1, num_buf):
            plane_base[b] = plane_base[b - 1] + starts[b - 1, self.n_chunks]
        self.types = types
        self.cell_start = data_start + plane_base[:, None] + starts[:, :-1]
        self.cell_size = starts[:, 1:] - starts[:, :-1]
        self.want = codec.plane_chunk_lengths(
            orig_size, chunk_size, num_buf, byte_reorder
        )
        self._check()
        t, sz, want = self.types, self.cell_size, self.want
        stored = (t == 0) | (sz == want)
        rle = ~stored & (sz == 1)
        self.kind = np.where(stored, KIND_STORED, np.where(rle, KIND_RLE, KIND_HUF))

    def _raise_first(self, bad, detail):
        b, c = np.argwhere(bad.T)[0][::-1]
        raise CorruptChunkError(
            f"{detail} (size {int(self.cell_size[b, c])}, want {int(self.want[b, c])})",
            plane=int(b), chunk=int(c),
        )

    def _check(self):
        t, sz, want = self.types, self.cell_size, self.want
        checks = (
            (t > 1, "unknown chunk type"),
            ((sz < 0) | (self.cell_start + sz > self.payload_np.size),
             "cell outside the payload"),
            ((t == 0) & (sz != want), "raw size mismatch"),
            ((t == 1) & (sz > want), "corrupt HUF block (larger than destination)"),
            ((t == 1) & (want == 0), "dst_size == 0"),
            ((t == 1) & (sz == 0), "empty HUF header"),
        )
        for bad, detail in checks:
            if np.any(bad):
                self._raise_first(bad, detail)


class Plan:
    """Per-stream arrays and per-cell tables of every Huffman cell.

    Huffman cells are numbered chunk-major (``huf_b``, ``huf_c``), so each
    chunk-range batch owns a contiguous run of cells and of streams (4
    per cell, ``4 * ordinal + k``).  The symbol buffer gives each cell a
    row of ``row`` bytes.
    """

    def __init__(self, g: Geometry):
        self.g = g
        cc, bb = np.nonzero(g.kind.T == KIND_HUF)
        self.huf_b, self.huf_c = bb, cc
        n = bb.size
        self.n_huf = n
        p = g.payload_np
        hcs = g.cell_start[bb, cc].astype(np.int64)
        hsz = g.cell_size[bb, cc].astype(np.int64)
        want = g.want[bb, cc].astype(np.int64)
        self.row = int(want.max()) if n else 0
        # header length follows from its first byte (raw 4-bit weights vs
        # FSE-compressed), so every header and jump table slices at once
        b0 = p[hcs].astype(np.int64) if n else np.zeros(0, np.int64)
        consumed = np.where(b0 >= 128, 1 + (b0 - 127 + 1) // 2, 1 + b0)
        self._raise_if(hsz < consumed + 6, "corrupt HUF block (missing jump table)")
        jt = hcs + consumed
        l1 = p[jt].astype(np.int64) | (p[jt + 1].astype(np.int64) << 8)
        l2 = p[jt + 2].astype(np.int64) | (p[jt + 3].astype(np.int64) << 8)
        l3 = p[jt + 4].astype(np.int64) | (p[jt + 5].astype(np.int64) << 8)
        l4 = hsz - consumed - 6 - l1 - l2 - l3
        lens4 = np.stack([l1, l2, l3, l4], axis=1)
        self._raise_if(np.any(lens4 <= 0, axis=1),
                       "corrupt HUF block (empty stream or jump table overruns input)")
        s0 = jt + 6
        starts4 = s0[:, None] + np.concatenate(
            [np.zeros((n, 1), np.int64), np.cumsum(lens4[:, :3], axis=1)], axis=1
        )
        seg = (want + 3) // 4
        outl4 = np.stack([seg, seg, seg, want - 3 * seg], axis=1)
        self._raise_if(outl4[:, 3] < 0, "corrupt HUF block (segment sizes)")
        last = p[(starts4 + lens4 - 1).reshape(-1)].reshape(n, 4)
        if np.any(last == 0):
            i, k = np.argwhere(last == 0)[0]
            raise CorruptChunkError(
                "corrupt bitstream: missing sentinel bit",
                plane=int(bb[i]), chunk=int(cc[i]), stream=int(k),
            )
        headers = [bytes(p[o : o + c]) for o, c in zip(hcs, consumed)]
        try:
            tables, tlogs, self.tlog_k = huf_pc.cell_tables(headers)
        except ValueError as exc:
            i = exc.index
            raise CorruptChunkError(
                str(exc), plane=int(bb[i]), chunk=int(cc[i])
            ) from exc
        self.tables, self.tlogs = tables, tlogs
        self.shared = (
            n >= 2 and self.tlog_k <= SHARED_TLOG_MAX
            and len(set(headers)) == 1
        )
        self.starts = starts4.reshape(-1)
        self.lens = lens4.reshape(-1).astype(np.int32)
        self.bits0 = huf_pc.sentinel_bits(last.reshape(-1), self.lens)
        self.out_lens = outl4.reshape(-1).astype(np.int32)
        stream_off = np.concatenate(
            [np.zeros((n, 1), np.int64), np.cumsum(outl4[:, :3], axis=1)], axis=1
        )
        self.out_offs = (
            np.arange(n, dtype=np.int64)[:, None] * self.row + stream_off
        ).reshape(-1)
        self.cells = np.repeat(np.arange(n, dtype=np.int32), 4)
        # K2's cell descriptors, chunk-major [n_chunks * num_buf]
        kind = g.kind.T.reshape(-1).astype(np.int32)
        src = g.cell_start.T.reshape(-1).copy()
        rle = kind == KIND_RLE
        src[rle] = p[src[rle]]
        hsel = kind == KIND_HUF
        src[hsel] = np.arange(n, dtype=np.int64)
        self.kinds, self.srcs = kind, src

    def _raise_if(self, bad, detail):
        if np.any(bad):
            i = int(np.nonzero(bad)[0][0])
            raise CorruptChunkError(
                detail, plane=int(self.huf_b[i]), chunk=int(self.huf_c[i])
            )

    def cell_range(self, lo: int, hi: int):
        """Huffman cell ordinals [h0, h1) of the chunks [lo, hi)."""
        return (int(np.searchsorted(self.huf_c, lo)),
                int(np.searchsorted(self.huf_c, hi)))


def batch_chunks(chunk_size: int) -> int:
    """Chunks per device batch: BATCH_BYTES of output bounds the symbol
    buffer and the rest of a batch's working set."""
    return max(1, BATCH_BYTES // chunk_size)


def plan_batches(n_chunks: int, chunk_size: int):
    B = batch_chunks(chunk_size)
    return [(lo, min(lo + B, n_chunks)) for lo in range(0, n_chunks, B)]


def check_streams(plan: Plan, bits_left: np.ndarray) -> None:
    """Every stream must have consumed its bits exactly."""
    bad = np.nonzero(bits_left != 0)[0]
    if bad.size:
        s = int(bad[0])
        raise CorruptChunkError(
            f"HUF stream not fully consumed ({int(bits_left[s])} bits left)",
            plane=int(plan.huf_b[s // 4]), chunk=int(plan.huf_c[s // 4]),
            stream=s % 4,
        )


def build_plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size,
               orig_size) -> Optional[Plan]:
    """Host plan of a container, or None when it holds no bytes.  Raises
    ``NotImplementedError`` for the parts of the format later slices
    port."""
    if num_buf not in (1, 2):
        raise NotImplementedError(
            f"{num_buf}-plane (fp32) containers are not ported to the CUDA "
            "engine yet (ROADMAP queue 1, M4 fp32); use engine='numpy'"
        )
    if chunk_size % 4:
        raise NotImplementedError(f"chunk size {chunk_size} is not a multiple of 4")
    if orig_size == 0:
        return None
    plan = Plan(Geometry(payload, num_buf, chunk_size, orig_size, bit_reorder,
                         byte_reorder))
    if plan.shared:
        raise NotImplementedError(
            "shared-table containers are not ported to the CUDA engine yet "
            "(ROADMAP queue 1, M5 shared-table decode); use engine='numpy'"
        )
    return plan


class DeviceInputs:
    """A plan's arrays on the device: the payload bytes, the per-stream
    arrays, the tables and K2's cell descriptors, uploaded once."""

    def __init__(self, plan: Plan, device: torch.device):
        def up(a):
            with warnings.catch_warnings():
                # the payload is a read-only view of the caller's buffer;
                # the pipeline never writes to it
                warnings.simplefilter("ignore", UserWarning)
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.plan = plan
        self.payload = up(plan.g.payload_np)
        self.starts, self.lens, self.bits0 = up(plan.starts), up(plan.lens), up(plan.bits0)
        self.out_offs, self.out_lens = up(plan.out_offs), up(plan.out_lens)
        self.cells, self.tlogs, self.tables = up(plan.cells), up(plan.tlogs), up(plan.tables)
        self.kinds, self.srcs = up(plan.kinds), up(plan.srcs)

    def k1_args(self, lo: int, hi: int):
        """``huf_pc_decode`` arguments for the Huffman cells of chunks
        [lo, hi): symbol rows numbered from the batch's first cell."""
        plan = self.plan
        h0, h1 = plan.cell_range(lo, hi)
        s = slice(4 * h0, 4 * h1)
        return (
            self.payload, self.starts[s], self.lens[s], self.bits0[s],
            self.out_offs[s] - h0 * plan.row, self.out_lens[s], self.cells[s],
            self.tlogs, self.tables, (h1 - h0) * plan.row,
        )

    def k2_args(self, lo: int, hi: int, hsym: torch.Tensor):
        """``combine_cells`` arguments (all but ``out``) for chunks [lo, hi)."""
        g = self.plan.g
        h0, _ = self.plan.cell_range(lo, hi)
        nb, cs = g.num_buf, g.chunk_size
        kinds = self.kinds[lo * nb : hi * nb]
        srcs = self.srcs[lo * nb : hi * nb]
        if h0:
            srcs = torch.where(kinds == KIND_HUF, srcs - h0, srcs)
        total = min(hi * cs, g.orig_size) - lo * cs
        return (
            self.payload, hsym, kinds, srcs.contiguous(), self.plan.row, cs,
            total, nb, g.byte_reorder, g.bit_reorder,
        )


def decompress_payload(
    payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size,
    device="cuda",
) -> torch.Tensor:
    """Decompress the table+planes payload into a uint8 tensor of
    ``orig_size`` bytes on ``device``.

    The tensor is a view of a buffer padded to whole words, so
    ``tensor.view(dtype)`` retypes it in place.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    last_timings.clear()
    t0 = time.perf_counter()
    plan = build_plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size,
                      orig_size)
    t1 = time.perf_counter()
    last_timings["plan_s"] = t1 - t0
    out = torch.empty(-(-orig_size // 4) * 4, dtype=torch.uint8, device=device)
    if plan is None:
        return out[:orig_size]
    dv = DeviceInputs(plan, device)
    if cuda:
        torch.cuda.synchronize(device)
    last_timings["upload_s"] = time.perf_counter() - t1

    stream = torch.cuda.current_stream(device) if cuda else None

    def mark():
        """A timing event on the decode's stream (None on the CPU)."""
        if stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    events = []
    bits_parts = []
    for lo, hi in plan_batches(plan.g.n_chunks, chunk_size):
        e0 = mark()
        hsym, bl = huf_pc.huf_pc_decode(*dv.k1_args(lo, hi))
        e1 = mark()
        combine.combine_cells(*dv.k2_args(lo, hi, hsym), out[lo * chunk_size :])
        events.append((e0, e1, mark()))
        bits_parts.append(bl)
    last_timings["events"] = events
    bits_left = torch.cat(bits_parts).cpu().numpy()
    check_streams(plan, bits_left)
    return out[:orig_size]


def kernel_ms() -> Dict[str, float]:
    """K1 / K2 device milliseconds of the last CUDA decompress (summed over
    batches); synchronises on the recorded events."""
    k1 = k2 = 0.0
    for ev in last_timings.get("events", []):
        if ev[0] is None:
            continue
        ev[2].synchronize()
        k1 += ev[0].elapsed_time(ev[1])
        k2 += ev[1].elapsed_time(ev[2])
    return {"huf_pc_decode": k1, "combine_cells": k2}
