"""Decompress a container straight into device memory.

The counterpart of the JAX package's ``ops/jax_decode.py`` for both
Huffman profiles (per-chunk tables, what the reference library writes,
and the shared-table profile of ``huffman_table="shared"``) and every
plane count (fp8: 1, bf16/fp16: 2, fp32: 4), split as its ``_start_fast``
is into :func:`start` and :func:`finish`:

1. **Host plan** (:class:`Geometry`, :class:`Plan`): parse the chunk
   tables, classify every (plane, chunk) cell as stored, RLE or Huffman —
   the ragged tail chunk included — slice every Huffman cell's header and
   jump table vectorised, and parse every distinct weight header into its
   decode table in one call to the native host core
   (``huf_pc.distinct_tables``).
2. **Pinned, pipelined uploads** (:class:`DeviceInputs`, through
   ``staging``): the plan's arrays, then each chunk-range batch's payload
   bytes (one range per plane: the payload is plane-major), copied into
   reused page-locked pieces while earlier pieces go up on the staging
   pool's copy stream; an event behind each batch's bytes.
3. **Chunk-range batches**, launched as soon as their bytes are queued:
   the compute stream waits on the batch's event, then a decode kernel
   writes the batch's Huffman streams into symbol rows — K6
   (``huf_shared.huf_shared_decode``) when every Huffman cell carries one
   weight header with tableLog <= 8 (:func:`takes_shared_table`), else K1
   (``huf_pc.huf_pc_decode``) — and kernel K2 (``combine.combine_cells``)
   assembles the batch's chunks into the output buffer in place.  So
   batch N+1's copies overlap batch N's kernels; device memory holds the
   payload, the output and one batch's symbol rows.
4. **End-of-stream check** (:func:`finish`): one fetch of every batch's
   ``bits_left``; every stream must end with ``bits_left == 0``, and the
   first that does not raises ``CorruptChunkError(plane, chunk, stream)``.
   With ``defer``, the check waits for :func:`validate_deferred`, which
   fetches the ``bits_left`` of many containers at once.

A streaming container is a row of frames, each a container of its own
(``streaming_chunk`` bytes of output, the last one shorter).  The frames
of one geometry whose chunks lie on one grid in the output
(:func:`frame_runs`: every frame that ``ZipNN.compress`` writes) decode
together as one container: the ``frames`` of :class:`Geometry` put their
cells side by side in chunk order, so one host plan and one K1/K6 + K2
launch set per batch of chunks cover many frames (:func:`decompress_run`),
and ``CorruptChunkError`` counts chunks across the run.

Under an ambient mesh (``parallel.use_mesh``) steps 2 and 3 run a shard
at a time: each batch's chunks are split over the mesh's entries
(``parallel.sharded.shards``, each shard on a word boundary of the
output), each device gets the plan's arrays and its shards' payload
ranges, and each shard's K1/K6 and K2 launch on its device, writing into
the output (or, from another device, through a copy).

:func:`stage` runs steps 1 and 2 only, for a later :func:`start_staged`
that copies nothing to the card; neither runs under a mesh.  On CPU tensors there is no staging (the
plan's arrays are the kernels' inputs) and the kernels' plain versions
run, so the same pipeline decodes on the host for the tests.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import codec, stats
from ..core import dtypes
from ..core.header import Header, walk_frames
from ..errors import CorruptChunkError
from ..parallel import sharded
from . import combine, huf_pc, huf_shared, kernels, staging

KIND_STORED, KIND_RLE, KIND_HUF = 0, 1, 2
BATCH_BYTES = 512 << 20  # output bytes per device batch

# what the last finished decode spent, for callers that report it:
# plan_s (host; of it geometry_s, the chunk tables' parse and checks, and
# plan_cpu_s, the planning thread's CPU seconds), stage_s (host copies
# into pinned memory), upload_s (the copy stream, from the end of the plan
# to the last batch's copy event), the decode kernel's name, the count of
# (batch, shard) ranges (``shards``: the batches with no mesh), and on CUDA
# the events recorded around each kernel launch
last_timings: Dict = {}


class Geometry:
    """Chunk tables and the per-cell classification of one container, or
    of a run of frames decoded as one.

    ``frames`` is None for one container's ``payload``; else the
    ``(offset, length, orig_size)`` of each frame's payload inside
    ``payload`` (a streaming container's bytes), each frame chunked by
    ``chunk_size`` and their outputs back to back (``orig_size`` is their
    sum): their cells line up in chunk order on a grid of ``min(chunk_size,
    the first frame's size)`` bytes, which :func:`frame_runs` checks.
    """

    def __init__(self, payload, num_buf, chunk_size, orig_size, bit_reorder,
                 byte_reorder, frames=None):
        self.payload_np = np.frombuffer(memoryview(payload), dtype=np.uint8)
        self.num_buf = num_buf
        self.orig_size = orig_size
        self.bit_reorder = bit_reorder
        self.byte_reorder = byte_reorder
        self.chunk_size = chunk_size
        if frames is None:
            frames = [(0, self.payload_np.size, orig_size)]
        else:
            self.chunk_size = min(chunk_size, frames[0][2])
        parts = [self._frame_cells(off, n, size, chunk_size) for off, n, size in frames]
        (self.types, self.cell_start, self.cell_size, self.want,
         self.cell_limit) = (np.concatenate(a, axis=1) for a in zip(*parts))
        self.n_chunks = self.types.shape[1]
        if self.n_chunks != codec.num_chunks_for(orig_size, self.chunk_size):
            raise ValueError("the frames' chunks do not lie on one grid")
        self._check()
        t, sz, want = self.types, self.cell_size, self.want
        stored = (t == 0) | (sz == want)
        rle = ~stored & (sz == 1)
        self.kind = np.where(stored, KIND_STORED, np.where(rle, KIND_RLE, KIND_HUF))

    def _frame_cells(self, off: int, n: int, size: int, chunk: int):
        """(types, cell starts in ``payload``, sizes, decoded sizes, end of
        the frame's payload) of the cells of one frame, [num_buf, chunks]
        each."""
        n_chunks = codec.num_chunks_for(size, chunk)
        types, starts, data_start = codec.parse_tables(
            memoryview(self.payload_np)[off : off + n], self.num_buf, n_chunks
        )
        plane_base = np.zeros(self.num_buf, dtype=np.int64)
        for b in range(1, self.num_buf):
            plane_base[b] = plane_base[b - 1] + starts[b - 1, n_chunks]
        want = codec.plane_chunk_lengths(size, chunk, self.num_buf, self.byte_reorder)
        return (types, off + data_start + plane_base[:, None] + starts[:, :-1],
                starts[:, 1:] - starts[:, :-1], want, np.full_like(want, off + n))

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
            ((sz < 0) | (self.cell_start + sz > self.cell_limit),
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
    """Per-stream arrays and decode tables of every Huffman cell.

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
            tables, tlogs, inv, self.tlog_k = huf_pc.distinct_tables(headers)
        except ValueError as exc:
            i = exc.index
            raise CorruptChunkError(
                str(exc), plane=int(bb[i]), chunk=int(cc[i])
            ) from exc
        self.tables, self.tlogs = tables, tlogs
        self.shared = takes_shared_table(headers, self.tlog_k)
        self.table8 = None
        if self.shared:
            try:
                self.table8 = huf_shared.expand_table8(headers[0])
            except ValueError as exc:
                raise CorruptChunkError(str(exc), plane=int(bb[0]),
                                        chunk=int(cc[0])) from exc
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
        # a table row per distinct header: K1 reads row ``cells[s]``
        self.cells = np.repeat(inv.astype(np.int32), 4)
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


def takes_shared_table(headers, tlog_k: int) -> bool:
    """Whether a plan's Huffman cells go to the shared-table kernel K6.

    The rule of the JAX package's ``_SharedPlan.build``: every Huffman
    cell carries the same weight header bytes, with tableLog <= 8 — so a
    per-chunk container whose tables happen to agree takes K6 as well,
    whatever encoder wrote it.  ``tlog_k`` is the largest tableLog.
    """
    return (len(headers) > 0 and tlog_k <= huf_shared.TMAX
            and len(set(headers)) == 1)


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
               orig_size, frames=None, timings: Optional[Dict] = None) -> Optional[Plan]:
    """Host plan of a container (or of a run of ``frames``, see
    :class:`Geometry`), or None when it holds no bytes.  ``timings``
    (optional) gets ``geometry_s``."""
    if num_buf not in (1, 2, 4):
        raise ValueError(f"unsupported plane count {num_buf}")
    if orig_size == 0:
        return None
    with stats.phase("decode:geometry"):
        t0 = time.perf_counter()
        g = Geometry(payload, num_buf, chunk_size, orig_size, bit_reorder, byte_reorder, frames)
        if timings is not None:
            timings["geometry_s"] = time.perf_counter() - t0
    with stats.phase("decode:plan-tables"):  # the rest of plan_s
        return Plan(g)


def payload_ranges(g: Geometry, lo: int, hi: int):
    """``(offset, length)`` of the payload bytes that the cells of chunks
    [lo, hi) occupy: a span per plane, from its first cell to its last,
    overlapping and adjacent spans merged.  In one container each plane's
    cells lie back to back, so the batches' ranges tile the payload's data
    region and the chunk tables in front of it never go to the card; in a
    run of frames the spans merge into one, which holds the headers and
    tables of the frames within it too."""
    ends = g.cell_start[:, hi - 1] + g.cell_size[:, hi - 1]
    ranges: List = []
    for s, e in sorted(zip(g.cell_start[:, lo].tolist(), ends.tolist())):
        if e <= s:
            continue
        if ranges and s <= ranges[-1][1]:
            ranges[-1][1] = max(ranges[-1][1], e)
        else:
            ranges.append([s, e])
    return [(s, e - s) for s, e in ranges]


class FrameRun:
    """Consecutive frames of a streaming container that decode as one
    container: the bytes [``start``, ``end``) of the container, their
    ``orig_size`` output bytes, the decode geometry ``key`` (planes, bit
    and byte reorder, chunk size) and the ``frames`` of :class:`Geometry`;
    ``frames`` is None for a whole-buffer method frame, which decodes on
    its own."""

    __slots__ = ("start", "end", "orig_size", "key", "frames", "_open")

    def __init__(self, start, end, orig_size, key, frames):
        self.start, self.end, self.orig_size = start, end, orig_size
        self.key, self.frames, self._open = key, frames, False

    @property
    def n_frames(self) -> int:
        return len(self.frames) if self.frames is not None else 1

    def add(self, end, payload, size) -> None:
        """Append a frame; the run stays open to the next while every
        frame has the first's size, a whole number of chunks or at most
        one (the output grid of :class:`Geometry`)."""
        first = self.frames[0][2] if self.frames else size
        self.frames.append((*payload, size))
        self.end, self.orig_size = end, self.orig_size + size
        self._open = size == first and size > 0 and size % min(self.key[3], size) == 0

    def takes(self, key) -> bool:
        return self._open and key == self.key


def frame_runs(buf, whole_buffer_reorders=()) -> List[FrameRun]:
    """Split a streaming container (frames back to back, as
    ``walk_frames`` finds them) into :class:`FrameRun` objects: each run the
    longest row of frames of one geometry that :class:`Geometry` can lay on
    one chunk grid -- every frame of a container that ``ZipNN.compress``
    wrote makes one run -- and each frame whose ``byte_reorder`` is one of
    ``whole_buffer_reorders`` a run of its own."""
    mv = memoryview(buf)
    runs: List[FrameRun] = []
    for off, total in walk_frames(mv):
        end = min(off + total, len(mv))
        hdr, consumed = Header.from_bytes(mv[off:end])
        if hdr.byte_reorder in whole_buffer_reorders:
            runs.append(FrameRun(off, end, hdr.original_len, None, None))
            continue
        num_buf = dtypes.groups_for_decompress(hdr.dtype_code)
        key = (num_buf, hdr.bit_reorder, hdr.byte_reorder,
               codec.effective_chunk(hdr.compression_chunk, num_buf))
        if not (runs and runs[-1].takes(key)):
            runs.append(FrameRun(off, off, 0, key, []))
        runs[-1].add(end, (off + consumed, end - off - consumed), hdr.original_len)
    return runs


def _packed(arrays):
    """The arrays' bytes back to back at 16-byte offsets, and each one's
    (offset, dtype, shape)."""
    layout, off = [], 0
    for a in arrays:
        layout.append((off, a.dtype, a.shape))
        off += -(-a.nbytes // 16) * 16
    buf = np.zeros(off, dtype=np.uint8)
    for a, (o, _, _) in zip(arrays, layout):
        buf[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return buf, layout


_TORCH = {np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
          np.dtype(np.int64): torch.int64}


class DeviceInputs:
    """A plan's arrays on ``device``: the payload bytes, the per-stream
    arrays, the decode kernel's tables and K2's cell descriptors.

    On a CUDA device they go up through the staging pool: the plan's
    arrays, packed into one buffer, when the inputs are made; each batch's
    payload ranges (:func:`payload_ranges`) at :meth:`upload`.  The device
    buffers are allocated on the copy stream that writes them and marked
    as used by the compute stream (``record_stream``), so the caching
    allocator hands their memory to neither stream before both are done
    with it.  On the CPU the plan's arrays are the inputs, and nothing is
    copied.
    """

    def __init__(self, plan: Plan, device, batches=None):
        device = torch.device(device)
        self.plan, self.device = plan, device
        self.batches = (plan_batches(plan.g.n_chunks, plan.g.chunk_size) if batches is None
                        else batches)
        self.events: List = []
        self.timings: Dict = {"stage_s": 0.0}
        arrays = [plan.starts, plan.lens, plan.bits0, plan.out_offs, plan.out_lens,
                  plan.kinds, plan.srcs]
        arrays += [plan.table8] if plan.shared else [plan.cells, plan.tlogs, plan.tables]
        packed, layout = _packed(arrays)
        self.src = staging.as_tensor(plan.g.payload_np)
        self.pool = None
        if device.type == "cuda":
            self.pool = staging.pool(device)
            compute = torch.cuda.current_stream(device)
            with stats.phase("decode:upload"):  # upload_s starts at start_event
                with torch.cuda.stream(self.pool.stream):
                    self.payload = torch.empty(self.src.numel(), dtype=torch.uint8,
                                               device=device)
                    buf = torch.empty(packed.size, dtype=torch.uint8, device=device)
                    self.start_event = torch.cuda.Event(enable_timing=True)
                    self.start_event.record(self.pool.stream)
                for t in (self.payload, buf):
                    t.record_stream(compute)
                staging.upload(self.pool, staging.as_tensor(packed), buf, [(0, packed.size)],
                               self.timings, label="decode")
        else:
            self.payload, buf = self.src, torch.from_numpy(packed)
        views = [buf[o : o + int(np.prod(shape)) * dt.itemsize].view(_TORCH[dt]).reshape(shape)
                 for o, dt, shape in layout]
        (self.starts, self.lens, self.bits0, self.out_offs, self.out_lens,
         self.kinds, self.srcs) = views[:7]
        if plan.shared:
            (self.table8,) = views[7:]
        else:
            self.cells, self.tlogs, self.tables = views[7:]
        self.ranges = [payload_ranges(plan.g, lo, hi) for lo, hi in self.batches]
        self.nbytes = packed.size + sum(n for r in self.ranges for _, n in r)  # bytes to the card

    def upload(self, i: int):
        """Queue batch ``i``'s payload bytes on the copy stream (batches in
        order) and return ``events[i]``, the event recorded there behind
        them and so behind the plan's arrays too; None on the CPU."""
        if self.pool is None:
            return None
        with stats.phase("decode:upload"):
            event = staging.upload(self.pool, self.src, self.payload, self.ranges[i],
                                   self.timings, label="decode")
        self.events.append(event)
        return event

    def decoder(self):
        """(name, wrapper, arguments of chunks [lo, hi)) of the plan's
        decode kernel: K6 for a shared-table plan, else K1."""
        if self.plan.shared:
            return "huf_shared_decode", huf_shared.huf_shared_decode, self.k6_args
        return "huf_pc_decode", huf_pc.huf_pc_decode, self.k1_args

    def _streams(self, lo: int, hi: int):
        plan = self.plan
        h0, h1 = plan.cell_range(lo, hi)
        s = slice(4 * h0, 4 * h1)
        return h0, h1, (
            self.payload, self.starts[s], self.lens[s], self.bits0[s],
            self.out_offs[s] - h0 * plan.row, self.out_lens[s],
        )

    def k1_args(self, lo: int, hi: int):
        """``huf_pc_decode`` arguments for the Huffman cells of chunks
        [lo, hi): symbol rows numbered from the batch's first cell."""
        h0, h1, st = self._streams(lo, hi)
        return (*st, self.cells[4 * h0 : 4 * h1], self.tlogs, self.tables,
                (h1 - h0) * self.plan.row)

    def k6_args(self, lo: int, hi: int):
        """``huf_shared_decode`` arguments for the Huffman cells of chunks
        [lo, hi), numbered as in :meth:`k1_args`."""
        h0, h1, st = self._streams(lo, hi)
        return (*st, self.table8, (h1 - h0) * self.plan.row)

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


class Staged:
    """A container planned and uploaded by :func:`stage`: ``plan`` (None
    for an empty container), ``inputs`` (its :class:`DeviceInputs`) and
    ``timings`` (``plan_s``, ``stage_s``)."""

    def __init__(self, plan: Optional[Plan], inputs: Optional[DeviceInputs],
                 orig_size: int, device: torch.device, timings: Dict):
        self.plan, self.inputs, self.orig_size = plan, inputs, orig_size
        self.device, self.timings = device, timings


class Started:
    """A decode in flight: every batch's kernels queued on the compute
    stream; :func:`finish` checks the streams and returns the output."""

    def __init__(self, plan: Optional[Plan], orig_size: int, device: torch.device,
                 timings: Dict, defer):
        self.plan, self.orig_size, self.timings, self.defer = plan, orig_size, timings, defer
        with stats.phase("decode:alloc"):
            self.out = torch.empty(-(-orig_size // 4) * 4, dtype=torch.uint8, device=device)
        self.bits: List[torch.Tensor] = []
        self.upload: List = []  # (first, last) copy-stream events of the uploads, per device

    def launch(self, dv: DeviceInputs, i: int) -> None:
        """Batch ``i`` of ``dv``, on its device: wait for its bytes, decode
        its Huffman streams, assemble its chunks into the output (through a
        buffer on that device and a copy, when the output lies on
        another)."""
        lo, hi = dv.batches[i]
        if dv.events:
            torch.cuda.current_stream(dv.device).wait_event(dv.events[i])
        name, decode_fn, args_of = dv.decoder()
        self.timings["decoder"] = name
        hsym, bl = decode_fn(*args_of(lo, hi))
        cs = self.plan.g.chunk_size
        k2 = dv.k2_args(lo, hi, hsym)
        if dv.device == self.out.device:
            combine.combine_cells(*k2, self.out[lo * cs :])
        else:
            total = k2[6]
            part = combine.combine_cells(*k2, torch.empty(-(-total // 4) * 4, dtype=torch.uint8,
                                                          device=dv.device))
            self.out[lo * cs : lo * cs + total].copy_(part[:total])
            bl = bl.to(self.out.device)
        self.bits.append(bl)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    return sharded.canonical(device)


def _no_mesh(what: str) -> None:
    mesh = sharded.get_default_mesh()
    if mesh is not None:
        raise ValueError(f"decode.{what}: the staged replay does not shard; it refuses the "
                         f"ambient mesh {mesh!r} (decode with decode.start, or leave "
                         "parallel.use_mesh)")


def _plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size, frames):
    timings = {"geometry_s": 0.0, "stage_s": 0.0}
    with stats.phase("decode:plan"):
        t0, c0 = time.perf_counter(), time.thread_time()
        plan = build_plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size,
                          frames, timings)
        timings["plan_s"] = time.perf_counter() - t0
        timings["plan_cpu_s"] = time.thread_time() - c0
    return plan, timings


def start(payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size,
          device="cuda", defer: Optional[list] = None, frames=None) -> Started:
    """Plan a container (or a run of ``frames``, see :class:`Geometry`),
    stage its uploads and queue every batch's kernels behind its bytes;
    :func:`finish` completes it.  With ``defer`` (a list), :func:`finish`
    appends the container's check there for :func:`validate_deferred`
    instead of fetching ``bits_left`` itself."""
    device = _device(device)
    plan, timings = _plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size,
                          orig_size, frames)
    run = Started(plan, orig_size, device, timings, defer)
    if plan is not None:
        # each batch's shards (one, with no mesh), each shard's inputs on
        # its device; a shard's output starts on a word boundary
        align = 4 // np.gcd(plan.g.chunk_size, 4)
        order, per_dev = [], {}
        for lo, hi in plan_batches(plan.g.n_chunks, plan.g.chunk_size):
            for dev, slo, shi in sharded.shards(lo, hi, device, align):
                order.append((dev, len(per_dev.setdefault(dev, []))))
                per_dev[dev].append((slo, shi))
        dvs = {dev: DeviceInputs(plan, dev, b) for dev, b in per_dev.items()}
        with kernels.recording() as events:
            for dev, i in order:
                dvs[dev].upload(i)
                run.launch(dvs[dev], i)
        timings["events"] = events
        timings["shards"] = len(order)
        timings["stage_s"] = sum(dv.timings["stage_s"] for dv in dvs.values())
        run.upload = [(dv.start_event, dv.events[-1]) for dv in dvs.values() if dv.events]
    return run


def stage(payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size,
          device="cuda", frames=None) -> Staged:
    """The plan and every upload of a container (the counterpart of the
    JAX package's ``stage_dev_batches``), for :func:`start_staged`.  Not
    under a mesh: raises ``ValueError``."""
    _no_mesh("stage")
    device = _device(device)
    plan, timings = _plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size,
                          orig_size, frames)
    dv = None
    if plan is not None:
        dv = DeviceInputs(plan, device)
        for i in range(len(dv.batches)):
            dv.upload(i)
        timings["stage_s"] = dv.timings["stage_s"]
    return Staged(plan, dv, orig_size, device, timings)


def start_staged(st: Staged, defer: Optional[list] = None) -> Started:
    """Queue the kernels of a :func:`stage`\\ d container; copies nothing
    to the card, so its plan, stage and upload seconds are 0 (the staged
    container's ``timings`` hold those of :func:`stage`).  A staged
    container starts any number of times.  Records no CUDA events of its
    own (its ``timings`` have no ``"events"``): a caller that times the
    kernels opens ``kernels.recording()`` around it.  Not under a mesh:
    raises ``ValueError``."""
    _no_mesh("start_staged")
    run = Started(st.plan, st.orig_size, st.device, {"plan_s": 0.0, "stage_s": 0.0}, defer)
    if st.plan is not None:
        for i in range(len(st.inputs.batches)):
            run.launch(st.inputs, i)
    return run


class Deferred:
    """One container's end-of-stream check, waiting for
    :func:`validate_deferred`."""

    def __init__(self, run: Started):
        self.plan, self.timings = run.plan, run.timings
        self.bits = torch.cat(run.bits) if len(run.bits) > 1 else run.bits[0]
        self.upload = run.upload

    def upload_s(self) -> float:
        """Seconds on the copy stream from the end of the plan to the last
        batch's copy event (0 on the CPU; under a mesh, the longest of the
        devices'); synchronises on it."""
        if not self.upload:
            return 0.0
        for _, last in self.upload:
            last.synchronize()
        return max(first.elapsed_time(last) for first, last in self.upload) / 1e3


def finish(run: Started) -> torch.Tensor:
    """Check the streams of a :func:`start`\\ ed decode (one fetch of every
    batch's ``bits_left``, or deferred) and return its output: a uint8
    tensor of ``orig_size`` bytes, a view of a buffer padded to whole words,
    so ``tensor.view(dtype)`` retypes it in place."""
    out = run.out[: run.orig_size]
    last_timings.clear()
    last_timings.update(run.timings)
    if run.plan is None:
        return out
    entry = Deferred(run)
    if run.defer is not None:
        run.defer.append(entry)
        return out
    validate_deferred([entry])
    last_timings.update(run.timings)
    return out


def validate_deferred(entries: List[Deferred]) -> None:
    """Fetch the ``bits_left`` of every entry at once and check each
    container in order: the first bad one raises the
    ``CorruptChunkError(plane, chunk, stream)`` its own decode raises.
    Fills each entry's ``upload_s``."""
    if not entries:
        return
    with stats.phase("decode:validate"):
        with stats.phase("decode:bits_fetch"):
            flat = torch.cat([e.bits for e in entries]).cpu().numpy()
        off = 0
        for e in entries:
            n = e.bits.numel()
            e.timings["upload_s"] = e.upload_s()
            check_streams(e.plan, flat[off : off + n])
            off += n


def decompress_payload(
    payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size,
    device="cuda",
) -> torch.Tensor:
    """Decompress the table+planes payload into a uint8 tensor of
    ``orig_size`` bytes on ``device``: ``finish(start(...))``."""
    return finish(start(payload, num_buf, bit_reorder, byte_reorder, chunk_size,
                        orig_size, device=device))


def decompress_run(buf, run: FrameRun, device="cuda") -> torch.Tensor:
    """The frames of a :func:`frame_runs` run of the streaming container
    ``buf`` decoded on ``device`` as one container (one host plan; a K1 or
    K6 and a K2 launch a batch): a uint8 tensor of ``run.orig_size``
    bytes."""
    return finish(start(buf, *run.key, run.orig_size, device=device, frames=run.frames))


def fetch(flat: torch.Tensor, dst: np.ndarray, timings: Dict) -> None:
    """Copy a decoded output into the host array ``dst``: from a CUDA
    device through the staging pool's pinned pieces (``staging.download``,
    which adds ``download_s`` and ``unstage_s``); adds the call's seconds
    to ``timings["fetch_s"]``."""
    with stats.phase("decode:fetch"):
        t0 = time.perf_counter()
        if flat.is_cuda:
            staging.download(staging.pool(flat.device), flat, dst, [(0, 0, flat.numel())],
                             timings, label="decode")
        else:
            dst[:] = flat.numpy()
        timings["fetch_s"] = timings.get("fetch_s", 0.0) + time.perf_counter() - t0


def kernel_ms() -> Dict[str, float]:
    """Device milliseconds of the last CUDA decompress by kernel name (its
    decode kernel, K1 or K6, and K2; summed over batches), from the events
    that ``kernels.launch`` recorded around each launch; synchronises on
    them.  :func:`start` records them; after :func:`start_staged`, which
    records none, every name reads 0."""
    return kernels.elapsed_ms(
        last_timings.get("events", []),
        (last_timings.get("decoder", "huf_pc_decode"), "combine_cells"))
