"""Compress a buffer on the card, either Huffman profile.

The counterpart of the JAX package's device encodes: the per-chunk
profile of ``jax_codec.compress_payload`` (its split, ``_histogram``,
``_plan_cell``, ``_encode`` and the bounded threshold check's post-pass)
and the shared-table profile of ``jax_codec.plan_fast_encode``,
``_assemble`` and ``fast_encode_payload_batched``, reduced to what the
format needs, split as its ``run(words, between=...)`` is into
:func:`start` and :func:`finish`.  The container equals the golden
encoder's (``codec.compress_payload_numpy``) byte for byte:

1. **Geometry**: the full chunks, the ragged tail and chunk-range batches;
   in the shared profile each batch is a multiple of the sampling stride
   (``codec.shared_sample_stride``, :func:`batch_chunks`).
2. **Shared profile, pass 1, the tables**: the per-plane byte histogram of
   the sampled chunks (every ``stride``-th chunk from 0, and the tail cell
   when its index is on stride), split and counted on the device, summed
   in int64; then ``codec.shared_tables_from_counts``.
3. **Per batch** (:func:`start`): the batch's words (a view of the
   caller's CUDA tensor, or host bytes uploaded from pinned staging) and
   the byte-plane split (``transforms.split_device``), then the profile's
   kernels:

   * shared: K8 (``const_scan.const_scan_rows``) over every (chunk, plane)
     row and K7 (``huf_enc.huf_shared_encode``) over the 4 streams of
     every cell of each live plane;
   * per-chunk: ``hist.hist_cells`` over every cell, one fetch of the
     counts, the plan of every cell (:func:`plan_cells`: the cheap RLE and
     raw checks vectorised, in the golden encoder's order, then every
     surviving cell's Huffman table in one call to the native core,
     ``native.build_ctables``), then ``huf_enc.huf_pc_encode`` over the 4
     streams of every Huffman cell, each with its cell's table.

   One device-to-host copy brings the bit counts (and K8's flags); the
   host takes every cell's decision (:func:`decide`) and, per-chunk, the
   bounded threshold check (:class:`Abandon`); then ``splice.splice_cells``
   writes the batch's cells on the device (:func:`assemble`: for each
   plane, its cells in chunk order, a raw cell from the split planes, a
   Huffman cell as its weight header, jump table and streams cut from the
   encoder's rows), and the batch's planes and rows are let go.  The
   plane-major layout puts plane ``b`` after every earlier plane's cells
   of every batch, so the assembled regions wait on the device until the
   last batch is decided.

   Chunks whose planes are not whole 4-byte words (planes under one word
   at the chunk sizes ``ZipNN`` takes) go by the sub-word route instead
   (:func:`encode_sub_word_batch`), either profile: a byte-wise split
   (``transforms.split_bytes``) and an RLE check on the device, the RLE
   and raw decisions on the host (such cells are never Huffman), one
   fetch of the cells' stored bytes, and the native core's splice in
   :func:`finish`.
4. **Container** (:func:`finish`): the tail cells on the host (per-chunk:
   the native core's block encoder, ``native.huf_compress``; shared:
   ``codec.compress_cell_shared`` with the plane's shared table), the
   output (a ``codec.frame``, or a caller's buffer) with ``prefix_len``
   bytes left for the caller's header, the chunk tables, and each
   assembled batch's plane regions fetched straight to their offsets
   through pinned pieces (``staging.download``), the copy stream waiting
   on an event behind the last assembly.

:func:`start` calls its ``between`` hook once, after the first kernels are
queued and before the first host sync (at once when nothing is launched):
a pipelined writer (``io.serving.ShardEncoder``) finishes the previous
container there while this one's kernels run.  On CPU tensors the
kernels' plain versions run, so the same pipeline encodes on the host for
the tests.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import codec, native
from . import byte_group, const_scan, hist, huf_enc, kernels, staging, transforms
from . import splice as dsplice
from .entropy import fse, huf
from .splice import HUF, RAW, RLE

BATCH_BYTES = 512 << 20  # input bytes per device batch

# what the last finished compress spent, for callers that report it: the
# encoder that ran ("huf_shared_encode", "huf_pc_encode", or "sub_word"
# for planes that are not whole words), the device kernels it launches
# ("kernels"), host-clock phase seconds (split_s, hist_s, plan_s,
# kernels_s, decide_s: the decisions' fetch and the host decisions,
# assemble_s: the cells written on the device, splice_s: the tail cells,
# the output and its tables and the host-spliced cells, upload_s: the
# input's copies into pinned staging), the copy stream's span of the
# payload's fetch (download_s) and the host copies out of pinned memory
# (unstage_s), the input bytes uploaded (upload_bytes), every byte moved
# each way (h2d_bytes: the input's uploads, the tables, stream offsets and
# cell descriptors; d2h_bytes), the batch count and, on CUDA, the events
# recorded around each kernel launch
last_timings: Dict = {}

SHARED_KERNELS = ("const_scan_rows", "huf_shared_encode", "splice_cells")
PC_KERNELS = ("hist_cells", "huf_pc_encode", "splice_cells")
SUB_WORD_CELL_BYTES = 64 << 20  # split bytes per batch of the sub-word route


def batch_chunks(chunk_size: int, stride: int) -> int:
    """Full chunks per device batch: a multiple of the sampling stride, so
    every batch starts on a sampled chunk, with BATCH_BYTES of input at
    most (one stride at least)."""
    return max(stride, BATCH_BYTES // (chunk_size * stride) * stride)


class Geometry:
    """Chunks, tail, sampling stride (1 in the per-chunk profile) and
    batches of one buffer, and the route: planes of whole 4-byte words,
    or (``sub_word``) planes of ``lens`` bytes shorter than 12 bytes,
    which are never Huffman."""

    def __init__(self, n: int, num_buf: int, chunk_size: int, shared: bool = True,
                 byte_reorder: int = 10):
        self.n, self.num_buf, self.chunk_size = n, num_buf, chunk_size
        self.lens = np.asarray(byte_group.plane_lengths(chunk_size, num_buf, byte_reorder),
                               dtype=np.int64)
        self.sub_word = chunk_size % (4 * num_buf) != 0
        if self.sub_word and self.lens.max() >= 12:
            raise ValueError(f"chunk size {chunk_size}: the device encoder needs planes of "
                             f"whole 4-byte words or planes under 12 bytes")
        self.full = n // chunk_size
        self.n_chunks = codec.num_chunks_for(n, chunk_size)
        self.stride = codec.shared_sample_stride(self.n_chunks) if shared else 1
        self.plane_bytes = chunk_size // num_buf
        self.seg = self.plane_bytes // 4  # bytes of each of a cell's 4 streams
        if self.sub_word:
            B = max(1, SUB_WORD_CELL_BYTES // (num_buf * int(self.lens.max())))
        else:
            B = batch_chunks(chunk_size, self.stride)
        self.batches = [(lo, min(lo + B, self.full)) for lo in range(0, self.full, B)]


class Source:
    """The full chunks as uint8 rows ``[full, chunk_size]`` on the device
    (int32 words ``[., chunk_size / 4]`` on the word route): a view of the
    caller's device tensor, or host bytes uploaded per batch (once, when
    one batch holds them all) through the staging pool's pinned pieces.
    Moves every small array between host and card through pinned memory
    (:meth:`put` without waiting, :meth:`get` waiting for the current
    stream), and counts the bytes it and the encoder move each way and the
    host seconds of the input's uploads."""

    def __init__(self, data, g: Geometry, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.sub_word = g.sub_word
        self.uploaded = self.h2d = self.d2h = 0
        self.upload_s = 0.0
        nfull = g.full * g.chunk_size
        self.rows = self.host = None
        if isinstance(data, torch.Tensor) and data.device.type != "cpu":
            flat = data.reshape(-1).to(device)
            head = flat[:nfull]
            if not g.sub_word and head.storage_offset() % 4:
                head = head.clone()  # a copy on the device, to a word boundary
            self.rows = head.view(g.full, g.chunk_size)
            self._tail = self.get_later(flat[nfull:])
            return
        if isinstance(data, torch.Tensor):
            data = data.reshape(-1).numpy()
        flat = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
        self.host = flat[:nfull].reshape(g.full, g.chunk_size)
        self._tail = (flat[nfull:], None)
        if len(g.batches) == 1:
            self.rows = self._up(self.host)

    @property
    def tail(self) -> np.ndarray:
        """The ragged tail's bytes on the host (waits for their copy)."""
        arr, done = self._tail
        if done is not None:
            done.synchronize()
        return arr

    def _up(self, rows: np.ndarray) -> torch.Tensor:
        t0 = time.perf_counter()
        src = staging.as_tensor(rows)
        if not self.cuda:
            return src.view(rows.shape)
        p = staging.pool(self.device)
        with torch.cuda.stream(p.stream):
            t = torch.empty(rows.shape, dtype=torch.uint8, device=self.device)
        t.record_stream(torch.cuda.current_stream(self.device))
        done = staging.upload(p, src, t.view(-1), [(0, rows.size)], {})
        torch.cuda.current_stream(self.device).wait_event(done)
        self.uploaded += rows.nbytes
        self.h2d += rows.nbytes
        self.upload_s += time.perf_counter() - t0
        return t

    def put(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device (a pinned copy sent without waiting;
        on the CPU the array itself), its bytes counted."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self.cuda:
            return t
        self.h2d += t.nbytes
        return t.pin_memory().to(self.device, non_blocking=True)

    def get_later(self, t: torch.Tensor):
        """(host array, event): ``t``'s copy into pinned memory, queued on
        the current stream; the array holds it once the event has
        completed (None on the CPU, where the array is ``t``'s)."""
        if not self.cuda:
            return t.numpy(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self.d2h += host.nbytes
        return host.numpy(), done

    def get(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host, through pinned memory, its bytes
        counted (waits for the current stream)."""
        arr, done = self.get_later(t)
        if done is not None:
            done.synchronize()
        return arr

    def _route(self, rows: torch.Tensor) -> torch.Tensor:
        return rows if self.sub_word else rows.view(torch.int32)

    def batch(self, lo: int, hi: int) -> torch.Tensor:
        if self.rows is not None:
            return self._route(self.rows[lo:hi])
        return self._route(self._up(self.host[lo:hi]))

    def sample(self, lo: int, hi: int, stride: int) -> torch.Tensor:
        """Chunks lo, lo + stride, ... below hi."""
        if self.rows is not None:
            return self._route(self.rows[lo:hi:stride])
        return self._route(self._up(np.ascontiguousarray(self.host[lo:hi:stride])))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Between:
    """The ``between`` hook of :func:`start`: calls ``fn`` (if any) the
    first time it is called.  Until then the phase clock does not
    synchronise the device, so the hook comes before the first host
    sync."""

    def __init__(self, fn: Optional[Callable[[], None]]):
        self.fn, self.fired = fn, fn is None

    def __call__(self) -> None:
        if not self.fired:
            self.fired = True
            self.fn()


def _tick(clock: Dict, key: str, t0: float, device: torch.device,
          between: Optional[Between] = None) -> float:
    """Add the seconds since ``t0`` to ``clock[key]``, after a sync unless
    ``between`` has yet to fire."""
    if between is None or between.fired:
        _sync(device)
    t = time.perf_counter()
    clock[key] = clock.get(key, 0.0) + t - t0
    return t


def sampled_counts(src: Source, g: Geometry, byte_reorder: int,
                   bit_reorder: int) -> torch.Tensor:
    """Shared profile, pass 1 on the device: [num_buf, 256] int64 byte
    counts of the sampled full chunks (the tail cell is the caller's)."""
    nb = g.num_buf
    counts = torch.zeros((nb, 256), dtype=torch.int64, device=src.device)
    for lo, hi in g.batches:
        planes = transforms.split_device(src.sample(lo, hi, g.stride), nb,
                                         byte_reorder, bit_reorder)
        for b in range(nb):
            counts[b] += torch.bincount(
                planes[:, b].contiguous().view(torch.uint8).reshape(-1), minlength=256)
    return counts


def cell_table(count: np.ndarray, n: int):
    """The Huffman table of one per-chunk cell of ``n`` bytes with byte
    counts ``count`` (past the RLE and raw checks of :func:`plan_cells`):
    (weight header bytes, ``huf_enc.pack_pc_table`` entries), or None when
    the golden ``huf.compress`` stores the cell raw (no code lengths, no
    header, or a header too long for the cell).  The plain Python version
    of ``native.build_ctables``, which :func:`plan_cells` calls."""
    max_sv = int(np.nonzero(count)[0][-1])
    table_log = fse.optimal_table_log(huf.HUF_TABLELOG_DEFAULT, n, max_sv, minus=1)
    lengths = huf.build_code_lengths(count, table_log)
    if lengths is None:
        return None
    table_log = int(lengths.max())
    header = huf.write_ctable(lengths, max_sv, table_log)
    if header is None or len(header) + 12 >= n:
        return None
    vals = huf.canonical_values(lengths, table_log)
    return header, huf_enc.pack_pc_table(vals, lengths)


@dataclass
class PcPlan:
    """One batch's per-chunk plan: ``rle`` [k, num_buf] (one repeated
    byte, ``b0``); the Huffman cells (flat indices ``c * num_buf + b``, in
    order), their weight headers (row ``i`` of ``headers``
    [m, native.HDR_STRIDE], ``hlen[i]`` bytes) and [m, 256] tables."""

    rle: np.ndarray
    b0: np.ndarray
    cand: np.ndarray
    headers: np.ndarray
    hlen: np.ndarray
    tables: np.ndarray


def plan_cells(counts: np.ndarray, n: int, abandoned: np.ndarray) -> PcPlan:
    """Each cell's plan from its byte counts ([k, num_buf, 256]), in the
    order of checks of the golden ``huf.compress`` (the JAX package's
    ``_plan_cell``): a cell of 0 or more than ``HUF_BLOCKSIZE_MAX`` bytes
    is raw (a constant one too); one repeated byte is RLE; a cell whose
    largest count is at most ``(n >> 7) + 4``, or under 12 bytes, is raw;
    else its table is built.  The cheap checks run vectorised over all
    cells, and the cells that pass them get their tables in one call to
    the native core (``native.build_ctables``, each row equal to
    :func:`cell_table`), packed for K7 with numpy.  Cells of ``abandoned``
    planes are raw."""
    k, nb, _ = counts.shape
    rle = np.zeros((k, nb), dtype=bool)
    b0 = np.zeros((k, nb), dtype=np.uint8)
    cand = np.zeros(0, dtype=np.int64)
    headers = np.zeros((0, native.HDR_STRIDE), dtype=np.uint8)
    hlen = np.zeros(0, dtype=np.int64)
    tables = np.zeros((0, 256), np.int16)
    if 0 < n <= huf.HUF_BLOCKSIZE_MAX:
        largest = counts.max(axis=2)
        live = ~abandoned[None, :]
        rle = (largest == n) & live
        b0 = counts.argmax(axis=2).astype(np.uint8)
        coded = live & ~rle & (largest > (n >> 7) + 4) & (n >= 12)
        f = np.nonzero(coded.reshape(-1))[0]
        if f.size:
            status, lengths, vals, hdrs, hl = native.build_ctables(
                counts.reshape(k * nb, 256)[f], n)
            ok = status == 1
            cand, headers, hlen = f[ok], hdrs[ok], hl[ok].astype(np.int64)
            tables = huf_enc.pack_pc_table(vals[ok], lengths[ok])
    return PcPlan(rle, b0, cand, headers, hlen, tables)


def decide(rle: np.ndarray, cand: np.ndarray, bits: np.ndarray, hlen: np.ndarray,
           plane_bytes: int, threshold: float):
    """Each full-chunk cell's kind and stored size, as the golden encoder
    and its threshold decide them.

    ``rle`` [k, num_buf]: the cells of one repeated byte that may be RLE
    (K8's flags; per-chunk, the plan's RLE cells); ``cand`` [m]: the cells
    K7 encoded (flat indices ``c * num_buf + b``), ``bits`` [m, 4] their
    streams' ``total_bits`` and ``hlen`` [m] the length of the weight
    header each would carry.  Returns (kind, size) [k, num_buf] and the
    stream bytes [m, 4].  An RLE cell is stored as one byte; else a cell
    is Huffman when K7 encoded it, no stream met an uncoded byte, every
    stream holds 1..65535 bytes and the block is shorter than
    ``plane_bytes - 1`` and than ``plane_bytes * threshold``; else raw.
    Every block, RLE too, must beat the threshold.
    """
    limit = plane_bytes * threshold
    kind = np.full(rle.shape, RAW, dtype=np.uint8)
    size = np.full(rle.shape, plane_bytes, dtype=np.int64)
    r = rle & (1 < limit)
    kind[r] = RLE
    size[r] = 1
    tb = bits.astype(np.int64).reshape(-1, 4)
    sb = ((tb & 0x3FFFFFFF) + 7) // 8
    comp = hlen + 6 + sb.sum(axis=1)
    ok = (~rle.reshape(-1)[cand] & ~((tb >> 30) & 1).any(axis=1)
          & ((sb >= 1) & (sb <= 65535)).all(axis=1)
          & (comp < plane_bytes - 1) & (comp < limit))
    kind.reshape(-1)[cand[ok]] = HUF
    size.reshape(-1)[cand[ok]] = comp[ok]
    return kind, size, sb


class Abandon:
    """The per-chunk profile's bounded threshold check
    (``codec.check_abandon_index``): the batch holding chunk ``idx`` knows
    every size up to it before its fetch; a plane whose stored bytes over
    chunks 0..idx exceed ``threshold`` times their raw bytes stores every
    later cell raw (RLE ones too; the tail cell as well), in that batch
    before its fetch and in each later batch before its kernels."""

    def __init__(self, n_chunks: int, percent: int, num_buf: int):
        self.idx = codec.check_abandon_index(n_chunks, percent)
        self.planes = np.zeros(num_buf, dtype=bool)
        self.stored = np.zeros(num_buf, dtype=np.int64)  # over chunks before the batch

    def apply(self, lo: int, kind: np.ndarray, size: np.ndarray, lens: np.ndarray,
              threshold: float) -> Optional[np.ndarray]:
        """Flip the cells after the check in the batch of chunks from
        ``lo`` (``lens`` [num_buf]: a full chunk's raw bytes per plane);
        returns the planes flipped here (None if the check is not in this
        batch)."""
        if self.idx is None or self.idx < lo:
            return None
        k = kind.shape[0]
        if self.idx >= lo + k:
            self.stored += size.sum(axis=0)
            return None
        j = self.idx - lo + 1  # chunks of this batch up to the check
        stored = self.stored + size[:j].sum(axis=0)
        flips = codec.check_abandon_planes(stored, (self.idx + 1) * lens, threshold)
        kind[j:, flips] = RAW
        size[j:, flips] = lens[flips]
        self.planes |= flips
        return flips


@dataclass
class Batch:
    """One sub-word batch's decisions ([k, num_buf] ``kind``, stored
    ``size``, the RLE bytes ``b0``; for Huffman cells the header index
    ``hid`` into the pool (header ``h`` at ``hpool[hoff[h]]``, ``hlen[h]``
    bytes) and the jump table ``jump`` [k, num_buf, 3], both None in a
    batch without Huffman cells) and its cells' bytes on the host: cell
    (c, b)'s Huffman streams or raw bytes from ``blob[boff[c, b]]``, which
    the native core's splice writes (:func:`_splice_host`)."""

    lo: int
    kind: np.ndarray
    size: np.ndarray
    b0: np.ndarray
    hid: Optional[np.ndarray]
    jump: Optional[np.ndarray]
    hpool: np.ndarray
    hoff: np.ndarray
    hlen: np.ndarray
    boff: np.ndarray
    blob: np.ndarray


@dataclass
class Assembled:
    """One batch's decisions ([k, num_buf] ``kind`` and stored ``size``) and
    its cells written on the device (:func:`assemble`): ``buf`` holds, for
    each plane ``b``, the batch's cells in chunk order, ``plane_bytes[b]``
    bytes from ``plane_off[b]``."""

    lo: int
    kind: np.ndarray
    size: np.ndarray
    buf: torch.Tensor
    plane_off: np.ndarray
    plane_bytes: np.ndarray


def _hpool(src: Source, headers: np.ndarray) -> torch.Tensor:
    """Weight headers on the device, padded to whole 16 bytes (never
    empty)."""
    pad = np.zeros(-(-max(headers.size, 1) // 16) * 16, np.uint8)
    pad[: headers.size] = headers
    return src.put(pad)


def assemble(src: Source, lo: int, kind: np.ndarray, size: np.ndarray, planes: torch.Tensor,
             rows: List[torch.Tensor], cand: np.ndarray, grp: np.ndarray, first: np.ndarray,
             sb: np.ndarray, hoff: np.ndarray, hlen: np.ndarray, hpool: torch.Tensor,
             clock: Dict, between: Between) -> Assembled:
    """Write a decided batch's cells on the device (``splice.splice_cells``)
    into a buffer of their stored bytes, plane-major: a raw or RLE cell
    from its row of ``planes`` ([k, num_buf, W] int32); Huffman candidate
    ``i`` (cell ``cand[i]``, flat index ``c * num_buf + b``, if decided
    Huffman) as its header (``hlen[i]`` bytes of ``hpool`` from
    ``hoff[i]``), jump table and streams, stream ``s`` from row
    ``first[i] + s`` of ``rows[grp[i]]``, cut to ``sb[i, s]`` bytes."""
    t = time.perf_counter()
    k, nb = kind.shape
    n = k * nb
    sz = size.T
    plane_bytes = sz.sum(axis=1)
    plane_off = np.cumsum(plane_bytes) - plane_bytes
    dst = (plane_off[:, None] + np.cumsum(sz, axis=1) - sz).T.reshape(-1)
    cells = np.zeros((n, dsplice.FIELDS), np.int64)
    cells[:, dsplice.DST] = dst
    cells[:, dsplice.INFO] = dsplice.info(size.reshape(-1), kind.reshape(-1))
    cells[:, dsplice.SRC] = np.arange(n)
    h = kind.reshape(-1)[cand] == HUF
    c = cand[h]
    cells[c, dsplice.INFO] = dsplice.info(size.reshape(-1)[c], HUF, 1 + grp[h], hlen[h])
    cells[c, dsplice.SRC] = dsplice.src(first[h], hoff[h])
    cells[c, dsplice.SB] = dsplice.pack_sb(sb[h])
    buf = torch.empty(int(plane_bytes.sum()), dtype=torch.uint8, device=src.device)
    groups = [planes.view(n, -1), *rows]
    dsplice.splice_cells(buf, cells, groups, hpool)
    if src.cuda:
        src.h2d += cells.nbytes + 16 * len(groups)
    _tick(clock, "assemble_s", t, src.device, between)
    return Assembled(lo, kind, size, buf, plane_off, plane_bytes)


def _split(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
           bit_reorder: int, clock: Dict, between: Between):
    words = src.batch(lo, hi)
    t = time.perf_counter()
    planes = transforms.split_device(words, g.num_buf, byte_reorder, bit_reorder)
    return planes, _tick(clock, "split_s", t, src.device, between)


def _streams(cells: torch.Tensor, pw: int) -> torch.Tensor:
    """Word offsets of the 4 streams of each cell (a flat index into the
    [k * num_buf, pw] plane rows)."""
    quarter = torch.arange(4, dtype=torch.int64, device=cells.device) * (pw // 4)
    return (cells[:, None] * pw + quarter).reshape(-1)


def encode_shared_batch(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
                        bit_reorder: int, tables: Dict[int, torch.Tensor], hpool: torch.Tensor,
                        hoff: np.ndarray, hlen: np.ndarray, threshold, clock: Dict,
                        between: Between) -> Assembled:
    """Shared profile, pass 2 on chunks [lo, hi): split, K8, K7, the
    decisions and the cells on the device.  Plane ``b``'s header is ``b``
    of the pool (``hpool``, ``hoff``, ``hlen``)."""
    nb, pw = g.num_buf, g.plane_bytes // 4
    k = hi - lo
    planes, t = _split(src, g, lo, hi, byte_reorder, bit_reorder, clock, between)
    flags = const_scan.const_scan_rows(planes.view(k * nb, pw))
    chunks = np.arange(k, dtype=np.int64) * nb
    cand = np.concatenate([chunks + b for b in tables] or [np.zeros(0, np.int64)])
    rows, bits = [], []
    for b, table in tables.items():
        r, tb = huf_enc.huf_shared_encode(planes, table, g.seg,
                                          _streams(src.put(chunks + b), pw))
        rows.append(r)
        bits.append(tb)
    between()
    dec = src.get(torch.cat([flags] + bits))
    t = _tick(clock, "kernels_s", t, src.device, between)
    flags_h = dec[: k * nb].reshape(k, nb)
    hid = np.repeat(np.asarray(list(tables), dtype=np.int64), k)
    kind, size, sb = decide((flags_h >> 8).astype(bool), cand, dec[k * nb :], hlen[hid],
                            g.plane_bytes, threshold)
    _tick(clock, "decide_s", t, src.device, between)
    return assemble(src, lo, kind, size, planes, rows, cand,
                    np.repeat(np.arange(len(tables)), k), np.tile(4 * np.arange(k), len(tables)),
                    sb, hoff[hid], hlen[hid], hpool, clock, between)


def encode_pc_batch(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
                    bit_reorder: int, threshold, abandon: Abandon, clock: Dict,
                    between: Between) -> Assembled:
    """Per-chunk profile on chunks [lo, hi): split, the cell histograms
    and their fetch, the plan (native tables), K7 over the Huffman cells'
    streams, the decisions and the threshold check, and the cells on the
    device."""
    nb, pw = g.num_buf, g.plane_bytes // 4
    k = hi - lo
    planes, t = _split(src, g, lo, hi, byte_reorder, bit_reorder, clock, between)
    counts = hist.hist_cells(planes.view(k * nb, pw))
    between()
    counts = src.get(counts)
    t = _tick(clock, "hist_s", t, src.device, between)
    plan = plan_cells(counts.reshape(k, nb, 256), g.plane_bytes, abandon.planes)
    t = _tick(clock, "plan_s", t, src.device, between)
    m = plan.cand.size
    rows, bits = [], np.zeros((0, 4), np.int32)
    if m:
        r, tb = huf_enc.huf_pc_encode(planes, src.put(plan.tables), g.seg,
                                      _streams(src.put(plan.cand), pw))
        rows = [r]
        bits = src.get(tb)
    t = _tick(clock, "kernels_s", t, src.device, between)
    kind, size, sb = decide(plan.rle, plan.cand, bits, plan.hlen, g.plane_bytes, threshold)
    abandon.apply(lo, kind, size, np.full(nb, g.plane_bytes, np.int64), threshold)
    _tick(clock, "decide_s", t, src.device, between)
    idx = np.arange(m, dtype=np.int64)
    return assemble(src, lo, kind, size, planes, rows, plan.cand, np.zeros(m, np.int64), 4 * idx,
                    sb, idx * native.HDR_STRIDE, plan.hlen, _hpool(src, plan.headers.reshape(-1)),
                    clock, between)


def encode_sub_word_batch(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
                          bit_reorder: int, threshold, abandon: Optional[Abandon],
                          clock: Dict, between: Between) -> Batch:
    """Either profile on chunks [lo, hi) whose planes are not whole words
    (``g.lens`` bytes, under 12: never Huffman).  On the device: the
    byte-wise split and each cell's RLE check (one repeated byte), one
    fetch of the flags; on the host: RLE where it beats the threshold
    (``1 < lens * threshold``), else raw, then the per-chunk threshold
    check (``abandon``; None in the shared profile); on the device again,
    the stored bytes of every cell in plane-major order (an RLE cell's one
    byte, a raw cell's plane bytes), fetched in one copy.  Only [num_buf]
    integers go up."""
    nb, k, dev = g.num_buf, hi - lo, src.device
    rows = src.batch(lo, hi)
    t = time.perf_counter()
    planes = transforms.split_bytes(rows, nb, byte_reorder, bit_reorder, g.lens.tolist())
    t = _tick(clock, "split_s", t, dev, between)
    lens = src.put(g.lens)
    inside = torch.arange(planes.shape[2], device=dev) < lens[:, None]  # [nb, pmax]
    flags = ((planes == planes[:, :, :1]) | ~inside).all(dim=2) & (lens > 0)
    between()
    flags_h = src.get(flags)
    t = _tick(clock, "kernels_s", t, dev, between)
    before = np.zeros(nb, bool) if abandon is None else abandon.planes.copy()
    rle_ok = (1 < g.lens * threshold) & ~before
    kind = np.where(flags_h & rle_ok, RLE, RAW).astype(np.uint8)
    size = np.where(kind == RLE, 1, g.lens).astype(np.int64)
    # the first row of the batch from which each plane stores raw
    cut = np.where(rle_ok, k, 0)
    if abandon is not None:
        flips = abandon.apply(lo, kind, size, g.lens, threshold)
        if flips is not None:
            cut[flips] = np.minimum(cut[flips], abandon.idx - lo + 1)
    rle = flags & (torch.arange(k, device=dev)[:, None] < src.put(cut)[None, :])
    keep = torch.where(rle[:, :, None], torch.arange(planes.shape[2], device=dev) == 0,
                       inside[None])
    blob = src.get(planes.permute(1, 0, 2)[keep.permute(1, 0, 2)])
    sz = size.T.reshape(-1)
    boff = (np.cumsum(sz) - sz).reshape(nb, k).T
    r = kind == RLE
    b0 = np.zeros((k, nb), dtype=np.uint8)
    b0[r] = blob[boff[r]]
    _tick(clock, "decide_s", t, dev, between)
    none = np.zeros(0, np.int64)
    return Batch(lo, kind, size, b0, None, None, np.zeros(0, np.uint8), none, none,
                 np.ascontiguousarray(boff), blob)


def _layout(g: Geometry, batches, tail, prefix_len: int,
            alloc: Callable[[int], np.ndarray] = codec.frame):
    """The output, ``alloc(n)``, with the chunk-type and cumulative-size
    tables written behind ``prefix_len`` bytes, and the absolute start of
    plane ``b``'s cell of chunk ``c`` (``base[b] + starts[b, c]``)."""
    nb = g.num_buf
    types = np.zeros((nb, g.n_chunks), dtype=np.uint8)
    sizes = np.zeros((nb, g.n_chunks), dtype=np.int64)
    for bt in batches:
        k = bt.kind.shape[0]
        types[:, bt.lo : bt.lo + k] = (bt.kind != RAW).T
        sizes[:, bt.lo : bt.lo + k] = bt.size.T
    if tail is not None:
        types[:, -1] = tail[0]
        sizes[:, -1] = tail[1]
    cumulative = np.cumsum(sizes, axis=1).astype("<u8")
    starts = np.zeros((nb, g.n_chunks + 1), dtype=np.int64)
    starts[:, 1:] = cumulative
    tbl_len = types.nbytes + cumulative.nbytes
    base = prefix_len + tbl_len + np.concatenate([[0], np.cumsum(starts[:, -1])[:-1]])
    out = alloc(prefix_len + tbl_len + int(starts[:, -1].sum()))
    out[prefix_len : prefix_len + types.nbytes] = types.reshape(-1)
    out[prefix_len + types.nbytes : prefix_len + tbl_len] = cumulative.view(np.uint8).reshape(-1)
    return out, base.astype(np.int64), starts


def _tail_cells(tail):
    """The tail's cells as a copy of each plane's stored block: (sizes,
    offsets into the joined blob, blob)."""
    sizes = np.asarray(tail[1], dtype=np.int64)
    return sizes, np.cumsum(sizes) - sizes, np.concatenate(tail[2])


def _splice_host(out: np.ndarray, base, starts, g: Geometry, batches: List[Batch],
                 tail) -> None:
    """Host-side batches' cells and the tail's, by the native core
    (``native.splice_cells``), at the output's offsets (:func:`_layout`).
    ``tail`` is None or (types [num_buf], sizes [num_buf], stored
    blocks)."""
    dummy16, dummy64 = np.zeros(3, np.uint16), np.zeros(1, np.int64)
    for bt in batches:
        k = bt.kind.shape[0]
        at = base[None, :] + starts[:, bt.lo : bt.lo + k].T
        native.splice_cells(
            out, at, bt.kind, bt.size, bt.b0,
            dummy64 if bt.hid is None else bt.hid, bt.hpool, bt.hoff, bt.hlen,
            dummy16 if bt.jump is None else bt.jump, bt.boff, bt.blob)
    if tail is not None:
        sizes, offs, blob = _tail_cells(tail)
        nb = g.num_buf
        native.splice_cells(out, base + starts[:, -2], np.zeros(nb, np.uint8), sizes,
                            np.zeros(nb, np.uint8), dummy64, np.zeros(0, np.uint8), dummy64,
                            dummy64, dummy16, offs, blob)


class Started:
    """An encode in flight (:func:`start`): every batch decided and, on the
    word route, its cells written on the device, where they wait for
    :func:`finish`; ``ready`` is a CUDA event behind the last of them (None
    on the CPU) and ``timings`` the phase seconds so far."""

    def __init__(self, g: Geometry, src: Source, batches: List[Union[Assembled, Batch]],
                 shared, abandon: Optional[Abandon], threshold: float, prefix_len: int,
                 reorder, timings: Dict):
        self.g, self.src, self.batches, self.shared, self.abandon = g, src, batches, shared, abandon
        self.threshold, self.prefix_len, self.reorder = threshold, prefix_len, reorder
        self.timings = timings
        self.ready = None
        if src.cuda:
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(src.device))


def _tail_planes(src: Source, g: Geometry, byte_reorder: int, bit_reorder: int):
    tail = src.tail
    return byte_group.split(tail, g.num_buf, byte_reorder, bit_reorder) if tail.size else None


def start(data, num_buf: int, bit_reorder: int, byte_reorder: int, chunk_size: int,
          threshold: float = codec.DEFAULT_THRESHOLD, check_th_after_percent: int = 0,
          shared_tables: bool = False, device="cuda", prefix_len: int = 0,
          between: Optional[Callable[[], None]] = None) -> Started:
    """Route, upload, split, histograms, plan, kernels, every cell's
    decision and every batch's cells on the device, for :func:`finish`.
    ``data`` is a host uint8 array or a uint8 tensor, read in place on its
    CUDA device.  ``between`` is called exactly once: after the first
    kernels are queued and before the first host sync (at once when
    nothing is launched)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    if isinstance(data, torch.Tensor):
        n = int(data.numel())
    else:
        data = np.frombuffer(memoryview(data), dtype=np.uint8)
        n = data.size
    g = Geometry(n, num_buf, chunk_size, shared_tables, byte_reorder)
    timings: Dict = {}
    if g.sub_word:
        timings.update(encoder="sub_word", kernels=())
    elif shared_tables:
        timings.update(encoder="huf_shared_encode", kernels=SHARED_KERNELS)
    else:
        timings.update(encoder="huf_pc_encode", kernels=PC_KERNELS)
    hook = Between(between)
    src = Source(data, g, device)
    abandon = None if shared_tables else Abandon(g.n_chunks, check_th_after_percent, num_buf)
    shared = [None] * num_buf
    args = (src, g)
    reorder = (byte_reorder, bit_reorder)
    with kernels.recording() as events:
        if g.sub_word:
            batches = [encode_sub_word_batch(*args, lo, hi, *reorder, threshold, abandon,
                                             timings, hook) for lo, hi in g.batches]
        elif shared_tables:
            t0, up0 = time.perf_counter(), src.upload_s
            counts = sampled_counts(src, g, *reorder)
            hook()
            counts = src.get(counts)
            tail_planes = _tail_planes(src, g, *reorder)
            if tail_planes is not None and g.full % g.stride == 0:
                for b, plane in enumerate(tail_planes):  # the tail cell is on stride
                    if plane.size:
                        counts[b] += np.bincount(plane, minlength=256)
            shared, live = codec.shared_tables_from_counts(counts, threshold, g.stride)
            # the sampled chunks' uploads (several batches of host input) count as upload
            timings["hist_s"] = time.perf_counter() - t0 - (src.upload_s - up0)
            hdrs = [b"" if t is None else t[2] for t in shared]
            hpool = _hpool(src, np.frombuffer(b"".join(hdrs), np.uint8))
            hlen = np.asarray([len(h) for h in hdrs], dtype=np.int64)
            hoff = np.cumsum(hlen) - hlen
            tables = {}
            if 12 <= g.plane_bytes <= huf.HUF_BLOCKSIZE_MAX:  # else every cell is raw or RLE
                for b in range(num_buf):
                    if live[b]:
                        lengths, vals, _, _ = shared[b]
                        tables[b] = src.put(huf_enc.pack_etable(vals, lengths))
            shared = [t if alive else None for t, alive in zip(shared, live)]
            batches = [encode_shared_batch(*args, lo, hi, *reorder, tables, hpool, hoff, hlen,
                                           threshold, timings, hook) for lo, hi in g.batches]
        else:
            batches = [encode_pc_batch(*args, lo, hi, *reorder, threshold, abandon, timings,
                                       hook) for lo, hi in g.batches]
    hook()
    timings["events"] = events
    return Started(g, src, batches, shared, abandon, threshold, prefix_len, reorder, timings)


def _tail(run: Started):
    """(types, sizes, stored blocks) of the tail chunk's cells, or None."""
    planes = _tail_planes(run.src, run.g, *run.reorder)
    if planes is None:
        return None
    nb = run.g.num_buf
    types = np.zeros(nb, dtype=np.uint8)
    sizes = np.zeros(nb, dtype=np.int64)
    blobs = []
    for b, plane in enumerate(planes):
        if run.abandon is None:
            comp = codec.compress_cell_shared(plane, run.shared[b])
        else:
            comp = None if run.abandon.planes[b] else native.huf_compress(plane)
        if comp is not None and len(comp) < plane.size * run.threshold:
            types[b] = 1
            blob = np.frombuffer(comp, np.uint8)
        else:
            blob = plane
        sizes[b] = blob.size
        blobs.append(blob)
    return types, sizes, blobs


def finish(run: Started, alloc: Callable[[int], np.ndarray] = codec.frame) -> np.ndarray:
    """The container of an encode that :func:`start` began, in ``alloc(n)`` (a
    writable uint8 array of ``n`` bytes; a new ``codec.frame`` by default):
    ``prefix_len`` bytes left for the caller's header, the chunk tables,
    the tail's and the sub-word batches' cells spliced on the host, and
    each assembled batch's plane regions fetched straight to their offsets
    (``staging.download`` on the card, the copy stream waiting on the
    event behind the last assembly).  Sets ``last_timings``."""
    g, src, timings = run.g, run.src, run.timings
    t0 = time.perf_counter()
    tail = _tail(run)
    out, base, starts = _layout(g, run.batches, tail, run.prefix_len, alloc)
    _splice_host(out, base, starts, g, [bt for bt in run.batches if isinstance(bt, Batch)], tail)
    timings["splice_s"] = time.perf_counter() - t0
    timings.update(download_s=0.0, unstage_s=0.0)
    for bt in run.batches:
        if not isinstance(bt, Assembled):
            continue
        ranges = [(int(bt.plane_off[b]), int(base[b] + starts[b, bt.lo]), int(bt.plane_bytes[b]))
                  for b in range(g.num_buf) if bt.plane_bytes[b]]
        if src.cuda:
            staging.download(staging.pool(src.device), bt.buf, out, ranges, timings,
                             after=run.ready)
            src.d2h += sum(r[2] for r in ranges)
        else:
            host = bt.buf.numpy()
            for s, d, m in ranges:
                out[d : d + m] = host[s : s + m]
    timings.update(upload_s=src.upload_s, upload_bytes=src.uploaded, h2d_bytes=src.h2d,
                   d2h_bytes=src.d2h, batches=len(run.batches))
    last_timings.clear()
    last_timings.update(timings)
    return out


def compress_payload(data, num_buf: int, bit_reorder: int, byte_reorder: int,
                     chunk_size: int, threshold: float = codec.DEFAULT_THRESHOLD,
                     check_th_after_percent: int = 0, shared_tables: bool = False,
                     device="cuda", prefix_len: int = 0) -> np.ndarray:
    """Compress ``data`` (a host uint8 array, or a uint8 tensor, read in
    place on its CUDA device) into the payload of either profile on
    ``device``: ``finish(start(...))``.  Its bytes equal
    ``codec.compress_payload_numpy(...)``'s for the same arguments
    (``check_th_after_percent`` applies to the per-chunk profile only, as
    there).  Returns a ``codec.frame`` that holds ``prefix_len`` bytes for
    the caller's header, then the payload."""
    return finish(start(data, num_buf, bit_reorder, byte_reorder, chunk_size, threshold,
                        check_th_after_percent, shared_tables, device, prefix_len))


def kernel_ms() -> Dict[str, float]:
    """Device milliseconds of the last CUDA compress by kernel name (the
    profile's two kernels, summed over batches), from the events that
    ``kernels.launch`` recorded around each launch; synchronises on
    them."""
    return kernels.elapsed_ms(last_timings.get("events", []),
                              last_timings.get("kernels", SHARED_KERNELS))
