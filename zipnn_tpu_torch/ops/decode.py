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

:func:`stage` runs steps 1 and 2 only, for a later :func:`start_staged`
that copies nothing to the card.  On CPU tensors there is no staging (the
plan's arrays are the kernels' inputs) and the kernels' plain versions
run, so the same pipeline decodes on the host for the tests.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import codec
from ..errors import CorruptChunkError
from . import combine, huf_pc, huf_shared, kernels, staging

KIND_STORED, KIND_RLE, KIND_HUF = 0, 1, 2
BATCH_BYTES = 512 << 20  # output bytes per device batch

# what the last finished decode spent, for callers that report it:
# plan_s (host), stage_s (host copies into pinned memory), upload_s (the
# copy stream, from the end of the plan to the last batch's copy event),
# the decode kernel's name, and on CUDA the events recorded around each
# kernel launch
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
               orig_size) -> Optional[Plan]:
    """Host plan of a container, or None when it holds no bytes."""
    if num_buf not in (1, 2, 4):
        raise ValueError(f"unsupported plane count {num_buf}")
    if orig_size == 0:
        return None
    return Plan(Geometry(payload, num_buf, chunk_size, orig_size, bit_reorder,
                         byte_reorder))


def payload_ranges(g: Geometry, lo: int, hi: int):
    """``(offset, length)`` of the payload bytes that the cells of chunks
    [lo, hi) occupy: one range per plane (each plane's cells lie back to
    back), adjacent ranges merged.  The batches' ranges tile the payload's
    data region; the chunk tables in front of it never go to the card."""
    ranges: List = []
    ends = g.cell_start[:, hi - 1] + g.cell_size[:, hi - 1]
    for s, e in zip(g.cell_start[:, lo].tolist(), ends.tolist()):
        if e <= s:
            continue
        if ranges and sum(ranges[-1]) == s:
            ranges[-1] = (ranges[-1][0], e - ranges[-1][0])
        else:
            ranges.append((s, e - s))
    return ranges


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

    def __init__(self, plan: Plan, device):
        device = torch.device(device)
        self.plan = plan
        self.batches = plan_batches(plan.g.n_chunks, plan.g.chunk_size)
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
            with torch.cuda.stream(self.pool.stream):
                self.payload = torch.empty(self.src.numel(), dtype=torch.uint8,
                                           device=device)
                buf = torch.empty(packed.size, dtype=torch.uint8, device=device)
                self.start_event = torch.cuda.Event(enable_timing=True)
                self.start_event.record(self.pool.stream)
            for t in (self.payload, buf):
                t.record_stream(compute)
            staging.upload(self.pool, staging.as_tensor(packed), buf, [(0, packed.size)],
                           self.timings)
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
        event = staging.upload(self.pool, self.src, self.payload, self.ranges[i],
                               self.timings)
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
        self.out = torch.empty(-(-orig_size // 4) * 4, dtype=torch.uint8, device=device)
        self.bits: List[torch.Tensor] = []
        self.upload = None  # (first, last) copy-stream event of this call's uploads

    def launch(self, dv: DeviceInputs, i: int) -> None:
        """Batch ``i``: wait for its bytes, decode its Huffman streams,
        assemble its chunks."""
        lo, hi = dv.batches[i]
        if dv.events:
            torch.cuda.current_stream(self.out.device).wait_event(dv.events[i])
        name, decode_fn, args_of = dv.decoder()
        self.timings["decoder"] = name
        hsym, bl = decode_fn(*args_of(lo, hi))
        cs = self.plan.g.chunk_size
        combine.combine_cells(*dv.k2_args(lo, hi, hsym), self.out[lo * cs :])
        self.bits.append(bl)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    return device


def _plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size):
    t0 = time.perf_counter()
    plan = build_plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size)
    return plan, {"plan_s": time.perf_counter() - t0, "stage_s": 0.0}


def start(payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size,
          device="cuda", defer: Optional[list] = None) -> Started:
    """Plan a container, stage its uploads and queue every batch's kernels
    behind its bytes; :func:`finish` completes it.  With ``defer`` (a
    list), :func:`finish` appends the container's check there for
    :func:`validate_deferred` instead of fetching ``bits_left`` itself."""
    device = _device(device)
    plan, timings = _plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size,
                          orig_size)
    run = Started(plan, orig_size, device, timings, defer)
    if plan is not None:
        dv = DeviceInputs(plan, device)
        with kernels.recording() as events:
            for i in range(len(dv.batches)):
                dv.upload(i)
                run.launch(dv, i)
        timings["events"] = events
        timings["stage_s"] = dv.timings["stage_s"]
        run.upload = (dv.start_event, dv.events[-1]) if dv.events else None
    return run


def stage(payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size,
          device="cuda") -> Staged:
    """The plan and every upload of a container (the counterpart of the
    JAX package's ``stage_dev_batches``), for :func:`start_staged`."""
    device = _device(device)
    plan, timings = _plan(payload, num_buf, bit_reorder, byte_reorder, chunk_size,
                          orig_size)
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
    container starts any number of times."""
    run = Started(st.plan, st.orig_size, st.device, {"plan_s": 0.0, "stage_s": 0.0}, defer)
    if st.plan is not None:
        with kernels.recording() as events:
            for i in range(len(st.inputs.batches)):
                run.launch(st.inputs, i)
        run.timings["events"] = events
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
        batch's copy event (0 on the CPU); synchronises on it."""
        if self.upload is None:
            return 0.0
        self.upload[1].synchronize()
        return self.upload[0].elapsed_time(self.upload[1]) / 1e3


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


def kernel_ms() -> Dict[str, float]:
    """Device milliseconds of the last CUDA decompress by kernel name (its
    decode kernel, K1 or K6, and K2; summed over batches), from the events
    that ``kernels.launch`` recorded around each launch; synchronises on
    them."""
    return kernels.elapsed_ms(
        last_timings.get("events", []),
        (last_timings.get("decoder", "huf_pc_decode"), "combine_cells"))
