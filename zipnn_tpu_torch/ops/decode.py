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

:func:`stage` runs step 1 and the payload's upload only.  A staged
container decodes in launch sets, one route for all: a :class:`Stack`
decodes many staged containers as one unit (their payloads in one
buffer; each container cut into pieces, a batch each; each run of pieces
of one geometry a :class:`LaunchSet`, one K1 launch per schedule and one
K2 launch for up to :data:`BATCH_BYTES` of output, its descriptors sent
up once, packed; the outputs views of one buffer; one fetch of every
``bits_left``), and :func:`start_staged` decodes a stack of one.
Neither runs under a mesh.  On CPU tensors there is no staging (the
plan's arrays are the kernels' inputs) and the kernels' plain versions
run, so the same pipeline decodes on the host for the tests.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import codec, stats
from ..core import dtypes
from ..core.header import Header, walk_frames
from ..errors import CorruptChunkError
from ..parallel import sharded
from . import combine, huf_pc, huf_shared, kernels, staging

KIND_STORED, KIND_RLE, KIND_HUF = 0, 1, 2
KIND_NAMES = tuple(kernels.combined_bytes)  # its keys, in the order of the kinds
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


def kind_bytes(g: Geometry, lo: int, hi: int) -> Dict[str, int]:
    """Plane bytes of the cells of chunks [lo, hi), by kind
    (:data:`KIND_NAMES`): what K2 assembles from each kind of cell."""
    kind, want = g.kind[:, lo:hi], g.want[:, lo:hi]
    return {name: int(want[kind == k].sum()) for k, name in enumerate(KIND_NAMES)}


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


def _views(buf: torch.Tensor, layout) -> List[torch.Tensor]:
    """The arrays that :func:`_packed` laid out, as views of ``buf``."""
    return [buf[o : o + int(np.prod(shape)) * dt.itemsize].view(_TORCH[dt]).reshape(shape)
            for o, dt, shape in layout]


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
        views = _views(buf, layout)
        (self.starts, self.lens, self.bits0, self.out_offs, self.out_lens,
         self.kinds, self.srcs) = views[:7]
        if plan.shared:
            (self.table8,) = views[7:]
        else:
            self.cells, self.tlogs, self.tables = views[7:]
        self.ranges = [payload_ranges(plan.g, lo, hi) for lo, hi in self.batches]
        self.kind_bytes = [kind_bytes(plan.g, lo, hi) for lo, hi in self.batches]

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
    """A container planned by :func:`stage`, its payload on the device:
    ``plan`` (None for an empty container), ``payload`` (the payload
    bytes on ``device``: on the CPU the host's own), ``events`` (on a CUDA
    device, the copy-stream event behind each batch's bytes), ``nbytes``
    (the bytes copied to the card) and ``timings`` (``plan_s``,
    ``stage_s``).  The plan's arrays stay on the host until a
    :class:`Stack` packs them into its launch sets."""

    def __init__(self, plan: Optional[Plan], orig_size: int, device: torch.device,
                 timings: Dict):
        self.plan, self.orig_size, self.device, self.timings = plan, orig_size, device, timings
        self.payload: Optional[torch.Tensor] = None
        self.events: List = []
        self.nbytes = 0


class Started:
    """A decode in flight: every batch's kernels queued on the compute
    stream; :func:`finish` checks the streams and returns the output.
    ``check`` is the check that :func:`finish` defers or runs: a
    :class:`StackCheck` for :func:`start_staged`, else None (the
    container's :class:`Deferred`)."""

    def __init__(self, plan: Optional[Plan], orig_size: int, device: torch.device,
                 timings: Dict, defer, out: Optional[torch.Tensor] = None,
                 check: Optional[StackCheck] = None):
        self.plan, self.orig_size, self.timings, self.defer = plan, orig_size, timings, defer
        if out is None:
            with stats.phase("decode:alloc"):
                out = torch.empty(-(-orig_size // 4) * 4, dtype=torch.uint8, device=device)
        self.out, self.check = out, check
        self.bits: List[torch.Tensor] = []
        self.upload: List = []  # (first, last) copy-stream events of the uploads, per device

    def launch(self, dv: DeviceInputs, i: int) -> None:
        """Batch ``i`` of ``dv``, on its device: wait for its bytes, decode
        its Huffman streams, assemble its chunks into the output (through a
        buffer on that device and a copy, when the output lies on
        another); add its bytes by cell kind to ``kernels.combined_bytes``."""
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
        for name, n in dv.kind_bytes[i].items():
            kernels.combined_bytes[name] += n


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
    """The plan of a container and its payload's upload, batch by batch
    (the counterpart of the JAX package's ``stage_dev_batches``), for
    :func:`start_staged` or a :class:`Stack`.  Not under a mesh: raises
    ``ValueError``."""
    _no_mesh("stage")
    device = _device(device)
    plan, timings = _plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size,
                          orig_size, frames)
    st = Staged(plan, orig_size, device, timings)
    if plan is not None:
        g = plan.g
        ranges = [payload_ranges(g, lo, hi) for lo, hi in plan_batches(g.n_chunks, g.chunk_size)]
        st.nbytes = sum(n for r in ranges for _, n in r)
        st.payload = staging.as_tensor(g.payload_np)
        if device.type == "cuda":
            with stats.phase("decode:upload"):
                st.payload, st.events = _upload(st.payload, device, ranges, timings)
    return st


def start_staged(st: Staged, defer: Optional[list] = None) -> Started:
    """Decode a :func:`stage`\\ d container as a :class:`Stack` of one: its
    payload read in place, its launch sets' descriptors packed and sent up
    at each start, so its plan, stage and upload seconds are 0 (the staged
    container's ``timings`` hold those of :func:`stage`).  A staged
    container starts any number of times.  Records no CUDA events of its
    own (its ``timings`` have no ``"events"``): a caller that times the
    kernels opens ``kernels.recording()`` around it.  Not under a mesh:
    raises ``ValueError``."""
    _no_mesh("start_staged")
    (out,), check = Stack([st], st.device).start()
    return Started(st.plan, st.orig_size, st.device, dict(STAGED_TIMINGS), defer, out, check)


class Deferred:
    """One container's end-of-stream check, waiting for
    :func:`validate_deferred`: its ``bits_left`` (``bits``, the one tensor
    of ``parts``) and :meth:`check` of what the fetch read of it."""

    def __init__(self, run: Started):
        self.plan, self.timings = run.plan, run.timings
        self.bits = torch.cat(run.bits) if len(run.bits) > 1 else run.bits[0]
        self.parts = [self.bits]
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

    def check(self, bits_left: np.ndarray) -> None:
        """Fill ``upload_s``; raise for the first stream not fully consumed."""
        self.timings["upload_s"] = self.upload_s()
        check_streams(self.plan, bits_left)


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
    entry = Deferred(run) if run.check is None else run.check
    if run.defer is not None:
        run.defer.append(entry)
        return out
    validate_deferred([entry])
    last_timings.update(run.timings)
    return out


def validate_deferred(entries) -> None:
    """Fetch the ``bits_left`` of every entry (a :class:`Deferred` or a
    :class:`StackCheck`) at once and check each in
    order: the first bad container raises the
    ``CorruptChunkError(plane, chunk, stream)`` its own decode raises.
    Fills each container's ``upload_s``."""
    if not entries:
        return
    with stats.phase("decode:validate"):
        with stats.phase("decode:bits_fetch"):
            parts = [b for e in entries for b in e.parts]
            flat = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.int32)
        off = 0
        for e in entries:
            n = sum(b.numel() for b in e.parts)
            e.check(flat[off : off + n])
            off += n


# ---------------------------------------------------------------------------
# launch sets: staged containers decoded as one unit
# ---------------------------------------------------------------------------

SET_ALIGN = 256  # a container's output and a piece's symbol rows start on this boundary
# the timings of each container of a staged decode: it plans and copies nothing
STAGED_TIMINGS = {"plan_s": 0.0, "stage_s": 0.0, "upload_s": 0.0, "decoder": "huf_pc_decode"}


def _round_up(n, align: int):
    return -(-n // align) * align


def _cumulative(sizes) -> np.ndarray:
    """Offsets of ``sizes`` laid back to back, and their total (last)."""
    return np.concatenate([[0], np.cumsum(np.asarray(sizes, dtype=np.int64))]).astype(np.int64)


def set_key(plan: Plan):
    """What the pieces of a launch set share: planes, byte and bit
    reorder, chunk size (the run's grid for frames)."""
    g = plan.g
    return (g.num_buf, g.byte_reorder, g.bit_reorder, g.chunk_size)


def _upload(src: torch.Tensor, device: torch.device, ranges, timings: Dict):
    """``src`` (host bytes) into a new buffer on the CUDA ``device``
    through the staging pool, one list of ``(offset, length)`` ranges of
    ``ranges`` after another.  The buffer is allocated on the copy stream
    and marked as used by the compute stream (``record_stream``).  Returns
    it and the copy-stream event behind each list."""
    pool = staging.pool(device)
    with torch.cuda.stream(pool.stream):
        buf = torch.empty(src.numel(), dtype=torch.uint8, device=device)
    buf.record_stream(torch.cuda.current_stream(device))
    return buf, [staging.upload(pool, src, buf, r, timings, label="decode") for r in ranges]


def _to_device(packed: np.ndarray, device: torch.device) -> torch.Tensor:
    """``packed`` on ``device`` for the compute stream: through the staging
    pool on a CUDA device (the compute stream waits for the copy), the
    array itself on the CPU."""
    if device.type != "cuda":
        return torch.from_numpy(packed)
    buf, (event,) = _upload(staging.as_tensor(packed), device, [[(0, packed.size)]], {})
    torch.cuda.current_stream(device).wait_event(event)
    return buf


class LaunchSet:
    """Pieces of staged containers of one geometry (:func:`set_key`),
    decoded by one K1 launch per schedule and one K2 launch.  A piece
    ``(m, lo, hi)`` is container ``m``'s chunks [lo, hi).

    Built once, from the containers' plans: K1's per-stream arrays of each
    piece (its streams, ``Plan.cell_range``) with each stream's start
    re-based into the unit's payload buffer (``payload``;
    ``payload_offs``, each container's offset there) and its output into
    the set's symbol rows, where each piece's rows start on a
    :data:`SET_ALIGN` boundary; the pieces' decode tables at the widest
    stride among them, ``cells`` re-based.  Each piece goes to the
    schedule that ``huf_pc.streams_per_warp`` gives its own streams, so a
    set launches K1 at most twice: the warp-schedule pieces' streams, then
    the lane-schedule ones'.  Every Huffman cell goes to K1, a
    shared-table one too (K1 decodes any tableLog <= 12).  K2's
    descriptors are the pieces' cells in order, stored sources re-based
    into the payload buffer and Huffman sources as byte offsets into the
    symbol rows, with each chunk's offset in the unit's output
    (``out_base``, each container's offset there) and length.  K2 is
    ``combine.combine_cells_grouped`` on a word grid (a chunk size that is
    a multiple of 4); else the set is one piece (:class:`Stack` makes it
    so) and K2 is ``combine.combine_cells`` on it, with ``hsym_row`` 1,
    since its Huffman sources are already byte offsets.  The descriptors
    reach the card here, once, packed into one buffer.
    """

    def __init__(self, plans: Sequence[Plan], pieces, payload: torch.Tensor,
                 payload_offs: Sequence[int], out_base: np.ndarray):
        self.pieces = pieces
        g0 = plans[pieces[0][0]].g
        self.n = len({m for m, _, _ in pieces})  # containers
        self.payload = payload
        self.geometry = (g0.chunk_size, g0.num_buf, g0.byte_reorder, g0.bit_reorder)
        cs, nb = g0.chunk_size, g0.num_buf
        cells = [plans[m].cell_range(lo, hi) for m, lo, hi in pieces]
        n_huf = [h1 - h0 for h0, h1 in cells]
        rows = [plans[m].row for m, _, _ in pieces]
        sym_base = _cumulative([_round_up(n * r, SET_ALIGN) for n, r in zip(n_huf, rows)])
        self.sym_bytes = int(sym_base[-1])
        group = [huf_pc.streams_per_warp(n * r, 4 * n, huf_pc.GROUP_SYMBOLS)
                 for n, r in zip(n_huf, rows)]
        order = [i for g in (1, 32) for i in range(len(pieces)) if group[i] == g and n_huf[i]]
        n_streams = [4 * n_huf[i] for i in order]
        stream_base = _cumulative(n_streams)
        self.n_streams = int(stream_base[-1])
        # each piece's streams [lo, hi) in the order of the K1 launches' bits_left
        self.streams = [(0, 0)] * len(pieces)
        for i, lo, hi in zip(order, stream_base[:-1].tolist(), stream_base[1:].tolist()):
            self.streams[i] = (lo, hi)
        # each K1 piece's plan, its slice of the plan's per-stream arrays, and its index
        mine = [(plans[pieces[i][0]], slice(4 * cells[i][0], 4 * cells[i][1]), i) for i in order]
        width = max((p.tables.shape[1] for p, _, _ in mine), default=1)
        table_base = _cumulative([p.tables.shape[0] for p, _, _ in mine])
        tables = np.zeros((int(table_base[-1]), width), dtype=np.int16)
        for (p, _, _), t0 in zip(mine, table_base.tolist()):
            tables[t0 : t0 + p.tables.shape[0], : p.tables.shape[1]] = p.tables

        def cat(arrays, dtype):
            return np.concatenate([np.zeros(0, dtype)] + list(arrays)).astype(dtype)

        k1 = [
            cat((p.starts[s] + payload_offs[pieces[i][0]] for p, s, i in mine), np.int64),
            cat((p.lens[s] for p, s, _ in mine), np.int32),
            cat((p.bits0[s] for p, s, _ in mine), np.int32),
            cat((p.out_offs[s] - cells[i][0] * p.row + sym_base[i] for p, s, i in mine),
                np.int64),
            cat((p.out_lens[s] for p, s, _ in mine), np.int32),
            cat((p.cells[s] + t0 for (p, s, _), t0 in zip(mine, table_base.tolist())), np.int32),
            cat((p.tlogs for p, _, _ in mine), np.int32),
            tables,
        ]
        kinds = [plans[m].kinds[lo * nb : hi * nb] for m, lo, hi in pieces]
        srcs = []
        for i, ((m, lo, hi), kind) in enumerate(zip(pieces, kinds)):
            src = plans[m].srcs[lo * nb : hi * nb].copy()
            src[kind == KIND_STORED] += payload_offs[m]
            huf = kind == KIND_HUF
            src[huf] = sym_base[i] + (src[huf] - cells[i][0]) * plans[m].row
            srcs.append(src)
        firsts = [np.arange(lo, hi, dtype=np.int64) * cs for _, lo, hi in pieces]
        k2 = [
            cat(kinds, np.int32),
            cat(srcs, np.int64),
            cat((out_base[m] + f for (m, _, _), f in zip(pieces, firsts)), np.int64),
            cat((np.minimum(cs, plans[m].g.orig_size - f) for (m, _, _), f in zip(pieces, firsts)),
                np.int32),
        ]
        packed, layout = _packed(k1 + k2)
        views = _views(_to_device(packed, payload.device), layout)
        n_warp = sum(n for i, n in zip(order, n_streams) if group[i] == 1)
        self.k1 = [(g, (payload, *(v[lo:hi] for v in views[:6]), *views[6:8]))
                   for g, lo, hi in ((1, 0, n_warp), (32, n_warp, self.n_streams)) if hi > lo]
        # K2's kernel, its arguments between ``hsym`` and ``out``, and where
        # in the unit's output its ``out`` starts
        if cs % 4 == 0:
            self.k2 = (combine.combine_cells_grouped, (*views[8:], 1, *self.geometry), 0)
        else:
            (m, lo, hi), = pieces
            total = min(hi * cs, plans[m].g.orig_size) - lo * cs
            self.k2 = (combine.combine_cells, (*views[8:10], 1, cs, total, *self.geometry[1:]),
                       int(out_base[m]) + lo * cs)
        per_piece = [kind_bytes(plans[m].g, lo, hi) for m, lo, hi in pieces]
        self.kind_bytes = {name: sum(b[name] for b in per_piece) for name in KIND_NAMES}

    def start(self, out: torch.Tensor, hsym: torch.Tensor) -> List[torch.Tensor]:
        """Queue the set's launches on the compute stream: K1 into the
        first :attr:`sym_bytes` of ``hsym`` (the unit's symbol buffer), K2
        into ``out`` (the unit's output).  Returns the K1 launches'
        ``bits_left`` (:attr:`streams` indexes them)."""
        sym = hsym[: self.sym_bytes]
        bits = [huf_pc.huf_pc_decode(*args, self.sym_bytes, out=sym, group=g)[1]
                for g, args in self.k1]
        k2, args, at = self.k2
        k2(self.payload, hsym, *args, out[at:])
        kernels.launch_sets["sets"] += 1
        kernels.launch_sets["containers"] += self.n
        for name, n in self.kind_bytes.items():
            kernels.combined_bytes[name] += n
        return bits


def _unit_payload(staged: Sequence[Staged], device: torch.device):
    """One buffer holding every container's staged payload, each at a
    16-byte offset, copied card to card on the compute stream once the
    container's uploads are done; each container's ``payload`` becomes its
    view, so no payload is held twice.  A stack of one reads its
    container's payload in place.  Returns (buffer, offsets)."""
    for st in staged:
        for event in st.events:
            torch.cuda.current_stream(device).wait_event(event)
    if len(staged) == 1 and staged[0].payload is not None:
        return staged[0].payload, [0]
    sizes = [st.payload.numel() if st.payload is not None else 0 for st in staged]
    offs = _cumulative([_round_up(n, 16) for n in sizes])
    unit = torch.empty(int(offs[-1]), dtype=torch.uint8, device=device)
    for st, o, n in zip(staged, offs.tolist(), sizes):
        if st.payload is not None:
            unit[o : o + n].copy_(st.payload)
            st.payload = unit[o : o + n]
    return unit, offs[:-1].tolist()


class Stack:
    """Staged containers decoded as one unit: ``io.serving``'s stacks, and
    :func:`start_staged`'s stack of one.

    At construction their payloads move into one buffer
    (:func:`_unit_payload`) and each container that holds bytes is cut
    into pieces, one per batch of :func:`plan_batches` (one piece for a
    container of at most :data:`BATCH_BYTES` of output).  The pieces form
    ``sets`` in order: each run of pieces of one geometry up to
    :data:`BATCH_BYTES` of output is a :class:`LaunchSet`, but for a piece
    whose chunk size is not a multiple of 4, which is a set of its own.
    ``views`` holds each container's (offset, size) in the unit's output,
    on a :data:`SET_ALIGN` boundary.  :meth:`start` decodes the unit.  Not
    under a mesh, as :func:`start_staged`.
    """

    def __init__(self, staged: Sequence[Staged], device):
        _no_mesh("stack")
        self.device = torch.device(device)
        self.plans = [st.plan for st in staged]
        self.payload, offs = _unit_payload(staged, self.device)
        sizes = [st.orig_size for st in staged]
        out_base = _cumulative([_round_up(n, SET_ALIGN) for n in sizes])
        self.out_bytes = int(out_base[-1])
        self.views = list(zip(out_base[:-1].tolist(), sizes))
        self.sets: List[LaunchSet] = []
        run: List = []
        key, size = None, 0

        def close():
            if run:
                self.sets.append(LaunchSet(self.plans, list(run), self.payload, offs, out_base))
                run.clear()

        for m, plan in enumerate(self.plans):
            if plan is None:
                continue
            cs = plan.g.chunk_size
            for lo, hi in plan_batches(plan.g.n_chunks, cs):
                n = _round_up(min(hi * cs, plan.g.orig_size) - lo * cs, SET_ALIGN)
                if run and (set_key(plan) != key or size + n > BATCH_BYTES or cs % 4):
                    close()
                if not run:
                    key, size = set_key(plan), 0
                run.append((m, lo, hi))
                size += n
        close()
        self.sym_bytes = max((ls.sym_bytes for ls in self.sets), default=0)
        # each container's streams in the unit's bits_left, as ranges in its
        # own stream order
        self.ranges: List[List] = [[] for _ in staged]
        pos = 0
        for ls in self.sets:
            for (m, _, _), (lo, hi) in zip(ls.pieces, ls.streams):
                self.ranges[m].append((pos + lo, pos + hi))
            pos += ls.n_streams

    def start(self):
        """Queue the unit's launches on the compute stream, set by set,
        each set inside a ``znn:decode:enqueue`` span (``stats.phase``).
        Returns the containers' outputs in order (uint8 views of one
        buffer, each ``orig_size`` bytes: the buffer is freed with the last
        of them) and the unit's :class:`StackCheck`."""
        with stats.phase("decode:alloc"):
            out = torch.empty(self.out_bytes, dtype=torch.uint8, device=self.device)
            hsym = torch.empty(self.sym_bytes, dtype=torch.uint8, device=self.device)
        parts: List[torch.Tensor] = []
        for ls in self.sets:
            with stats.phase("decode:enqueue"):
                parts += ls.start(out, hsym)
        return [out[o : o + n] for o, n in self.views], StackCheck(self, parts)


class StackCheck:
    """A :class:`Stack`'s end-of-stream check, waiting for
    :func:`validate_deferred`: ``parts``, the ``bits_left`` of its sets'
    K1 launches in order.  One ``any`` over the unit's streams; if one is
    bad, ``check_streams`` of each container in order over its streams in
    its own order, so the first container with a bad one raises its own
    ``CorruptChunkError``."""

    def __init__(self, stack: Stack, parts: List[torch.Tensor]):
        self.stack, self.parts = stack, parts

    def check(self, bits_left: np.ndarray) -> None:
        if np.any(bits_left):
            for plan, ranges in zip(self.stack.plans, self.stack.ranges):
                if ranges:
                    check_streams(plan, np.concatenate([bits_left[lo:hi] for lo, hi in ranges]))


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
