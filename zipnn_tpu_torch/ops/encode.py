"""Compress a buffer on the card, either Huffman profile.

The counterpart of the JAX package's device encodes: the per-chunk
profile of ``jax_codec.compress_payload`` (its split, ``_histogram``,
``_plan_cell``, ``_encode`` and the bounded threshold check's post-pass)
and the shared-table profile of ``jax_codec.plan_fast_encode``,
``_assemble`` and ``fast_encode_payload_batched``, reduced to what the
format needs.  The container it returns equals the golden encoder's
(``codec.compress_payload_numpy``) byte for byte:

1. **Geometry**: the full chunks, the ragged tail and chunk-range batches;
   in the shared profile each batch is a multiple of the sampling stride
   (``codec.shared_sample_stride``, :func:`batch_chunks`).
2. **Shared profile, pass 1, the tables**: the per-plane byte histogram of
   the sampled chunks (every ``stride``-th chunk from 0, and the tail cell
   when its index is on stride), split and counted on the device, summed
   in int64; then ``codec.shared_tables_from_counts``.
3. **Per batch**: the batch's words (a view of the caller's CUDA tensor,
   or uploaded) and the byte-plane split (``transforms.split_device``),
   then the profile's kernels:

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
   bounded threshold check (:class:`Abandon`); a second copy brings the
   bytes the container needs (:func:`fetch`): each Huffman stream's bytes
   and the raw cells.

   Chunks whose planes are not whole 4-byte words (planes under one word
   at the chunk sizes ``ZipNN`` takes) go by the sub-word route instead
   (:func:`encode_sub_word_batch`), either profile: a byte-wise split
   (``transforms.split_bytes``) and an RLE check on the device, the RLE
   and raw decisions on the host (such cells are never Huffman), and one
   fetch of the cells' stored bytes.
4. **Tail and output**: the per-chunk tail cell goes through the native
   core's block encoder (``native.huf_compress``), the shared one through
   ``codec.compress_cell_shared`` with the plane's shared table; the chunk
   tables and every cell are written at their global offsets into one
   ``codec.frame`` behind ``prefix_len`` bytes left for the caller's
   header (:func:`splice`, the native core's ``splice_cells``), so several
   batches stitch into one container and the header joins it without a
   copy.

On CPU tensors the kernels' plain versions run, so the same pipeline
encodes on the host for the tests.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import codec, native
from . import byte_group, const_scan, hist, huf_enc, kernels, transforms
from .entropy import fse, huf

RAW, RLE, HUF = 0, 1, 2
BATCH_BYTES = 512 << 20  # input bytes per device batch

# what the last compress spent, for callers that report it: the encoder
# that ran ("huf_shared_encode", "huf_pc_encode", or "sub_word" for
# planes that are not whole words), the
# device kernels it launches ("kernels"), host-clock phase seconds
# (split_s, hist_s, plan_s, kernels_s, fetch_s, splice_s, upload_s), the
# input bytes uploaded (upload_bytes), every byte moved each way
# (h2d_bytes: the input's uploads, the tables and the fetch indices;
# d2h_bytes), the batch count and, on CUDA, the events recorded around
# each kernel launch
last_timings: Dict = {}

SHARED_KERNELS = ("const_scan_rows", "huf_shared_encode")
PC_KERNELS = ("hist_cells", "huf_pc_encode")
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
    one batch holds them all).  Counts the bytes it and the encoder move
    each way and the seconds the input's uploads take."""

    def __init__(self, data, g: Geometry, device: torch.device):
        self.device = device
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
            self.tail = flat[nfull:].cpu().numpy()
            self.d2h += self.tail.size
            return
        if isinstance(data, torch.Tensor):
            data = data.reshape(-1).numpy()
        flat = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
        self.host = flat[:nfull].reshape(g.full, g.chunk_size)
        self.tail = flat[nfull:]
        if len(g.batches) == 1:
            self.rows = self._up(self.host)

    def _up(self, rows: np.ndarray) -> torch.Tensor:
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            # a read-only view of the caller's buffer; never written to
            warnings.simplefilter("ignore", UserWarning)
            t = self.put(rows)
        if self.device.type == "cuda":
            self.uploaded += rows.nbytes
            _sync(self.device)
        self.upload_s += time.perf_counter() - t0
        return t

    def put(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device, its bytes counted."""
        if self.device.type == "cuda":
            self.h2d += arr.nbytes
        return torch.from_numpy(arr).to(self.device)

    def get(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host, its bytes counted."""
        out = t.cpu().numpy()
        if self.device.type == "cuda":
            self.d2h += out.nbytes
        return out

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


def _tick(clock: Dict, key: str, t0: float, device: torch.device) -> float:
    """Add the seconds since ``t0`` (after a sync) to ``clock[key]``."""
    _sync(device)
    t = time.perf_counter()
    clock[key] = clock.get(key, 0.0) + t - t0
    return t


def sampled_counts(src: Source, g: Geometry, byte_reorder: int, bit_reorder: int,
                   tail_planes) -> np.ndarray:
    """Shared profile, pass 1: [num_buf, 256] int64 byte counts of the
    sampled cells."""
    nb = g.num_buf
    counts = torch.zeros((nb, 256), dtype=torch.int64, device=src.device)
    for lo, hi in g.batches:
        planes = transforms.split_device(src.sample(lo, hi, g.stride), nb,
                                         byte_reorder, bit_reorder)
        for b in range(nb):
            counts[b] += torch.bincount(
                planes[:, b].contiguous().view(torch.uint8).reshape(-1), minlength=256)
    out = src.get(counts)
    if tail_planes is not None and g.full % g.stride == 0:
        for b, plane in enumerate(tail_planes):  # the tail cell is on stride
            if plane.size:
                out[b] += np.bincount(plane, minlength=256)
    return out


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
    """One batch's decisions ([k, num_buf] ``kind``, stored ``size``, the
    RLE bytes ``b0``; for Huffman cells the header index ``hid`` into the
    pool (header ``h`` at ``hpool[hoff[h]]``, ``hlen[h]`` bytes) and the
    jump table ``jump`` [k, num_buf, 3], both None in a batch without
    Huffman cells) and the bytes fetched for its cells: cell (c, b)'s
    Huffman streams or raw bytes from ``blob[boff[c, b]]``."""

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


def fetch(src: Source, planes: torch.Tensor, kind: np.ndarray, cand: np.ndarray,
          sb: np.ndarray, groups: List[torch.Tensor]):
    """The bytes the container needs, in one device-to-host copy: the
    Huffman cells' streams, then the raw cells.  ``groups`` hold K7's rows
    of the ``cand`` cells in order (4 rows a cell).  Returns (blob, boff
    [k, num_buf])."""
    dev = src.device
    k, nb = kind.shape
    pb = planes.shape[-1] * 4
    flat_kind = kind.reshape(-1)
    boff = np.zeros(k * nb, dtype=np.int64)
    parts, pos, start = [], 0, 0
    for rows in groups:
        m = rows.shape[0] // 4
        sel = np.nonzero(flat_kind[cand[start : start + m]] == HUF)[0]
        if sel.size:
            s = sb[start + sel]
            width = int(s.max())
            pick = src.put((sel[:, None] * 4 + np.arange(4)).reshape(-1))
            got = rows.view(torch.uint8)[:, :width].index_select(0, pick)
            keep = torch.arange(width, device=dev) < src.put(s.reshape(-1))[:, None]
            parts.append(got[keep])
            tot = s.sum(axis=1)
            boff[cand[start + sel]] = pos + np.cumsum(tot) - tot
            pos += int(tot.sum())
        start += m
    raw = np.nonzero(flat_kind == RAW)[0]
    if raw.size:
        parts.append(planes.reshape(k * nb, -1)[src.put(raw)].reshape(-1).view(torch.uint8))
        boff[raw] = pos + np.arange(raw.size) * pb
    blob = src.get(torch.cat(parts)) if parts else np.zeros(0, np.uint8)
    return blob, boff.reshape(k, nb)


def _batch(lo, kind, size, b0, cand, sb, hid, hpool, hoff, hlen, blob, boff) -> Batch:
    k, nb = kind.shape
    hidk = np.full(k * nb, -1, dtype=np.int64)
    hidk[cand] = hid
    jump = np.zeros((k * nb, 3), dtype=np.uint16)
    jump[cand] = sb[:, :3]
    return Batch(lo, kind, size, b0, hidk.reshape(k, nb), jump.reshape(k, nb, 3),
                 hpool, np.asarray(hoff, np.int64), np.asarray(hlen, np.int64), boff, blob)


def _split(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
           bit_reorder: int, clock: Dict):
    words = src.batch(lo, hi)
    t = time.perf_counter()
    planes = transforms.split_device(words, g.num_buf, byte_reorder, bit_reorder)
    return planes, _tick(clock, "split_s", t, src.device)


def _streams(cells: torch.Tensor, pw: int) -> torch.Tensor:
    """Word offsets of the 4 streams of each cell (a flat index into the
    [k * num_buf, pw] plane rows)."""
    quarter = torch.arange(4, dtype=torch.int64, device=cells.device) * (pw // 4)
    return (cells[:, None] * pw + quarter).reshape(-1)


def encode_shared_batch(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
                        bit_reorder: int, tables: Dict[int, torch.Tensor], hpool, hoff, hlen,
                        threshold, clock: Dict) -> Batch:
    """Shared profile, pass 2 on chunks [lo, hi): split, K8, K7, the
    decisions, and the fetch of the bytes the container needs.  Plane
    ``b``'s header is ``b`` of the pool (``hpool``, ``hoff``, ``hlen``)."""
    nb, pw = g.num_buf, g.plane_bytes // 4
    k = hi - lo
    planes, t = _split(src, g, lo, hi, byte_reorder, bit_reorder, clock)
    flags = const_scan.const_scan_rows(planes.view(k * nb, pw))
    chunks = np.arange(k, dtype=np.int64) * nb
    cand = np.concatenate([chunks + b for b in tables] or [np.zeros(0, np.int64)])
    rows, bits = [], []
    for b, table in tables.items():
        r, tb = huf_enc.huf_shared_encode(planes, table, g.seg,
                                          _streams(src.put(chunks + b), pw))
        rows.append(r)
        bits.append(tb)
    t = _tick(clock, "kernels_s", t, src.device)
    dec = src.get(torch.cat([flags] + bits))
    flags_h = dec[: k * nb].reshape(k, nb)
    hid = np.repeat(np.asarray(list(tables), dtype=np.int64), k)
    kind, size, sb = decide((flags_h >> 8).astype(bool), cand, dec[k * nb :], hlen[hid],
                            g.plane_bytes, threshold)
    blob, boff = fetch(src, planes, kind, cand, sb, rows)
    _tick(clock, "fetch_s", t, src.device)
    return _batch(lo, kind, size, (flags_h & 0xFF).astype(np.uint8), cand, sb, hid,
                  hpool, hoff, hlen, blob, boff)


def encode_pc_batch(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
                    bit_reorder: int, threshold, abandon: Abandon, clock: Dict) -> Batch:
    """Per-chunk profile on chunks [lo, hi): split, the cell histograms
    and their fetch, the plan (native tables), K7 over the Huffman cells'
    streams, the decisions and the threshold check, and the fetch of the
    bytes the container needs."""
    nb, pw = g.num_buf, g.plane_bytes // 4
    k = hi - lo
    planes, t = _split(src, g, lo, hi, byte_reorder, bit_reorder, clock)
    counts = src.get(hist.hist_cells(planes.view(k * nb, pw)))
    t = _tick(clock, "hist_s", t, src.device)
    plan = plan_cells(counts.reshape(k, nb, 256), g.plane_bytes, abandon.planes)
    t = _tick(clock, "plan_s", t, src.device)
    rows, bits = [], np.zeros((0, 4), np.int32)
    if plan.cand.size:
        r, tb = huf_enc.huf_pc_encode(planes, src.put(plan.tables), g.seg,
                                      _streams(src.put(plan.cand), pw))
        rows = [r]
        bits = src.get(tb)
    t = _tick(clock, "kernels_s", t, src.device)
    kind, size, sb = decide(plan.rle, plan.cand, bits, plan.hlen, g.plane_bytes, threshold)
    abandon.apply(lo, kind, size, np.full(nb, g.plane_bytes, np.int64), threshold)
    blob, boff = fetch(src, planes, kind, plan.cand, sb, rows)
    _tick(clock, "fetch_s", t, src.device)
    m = plan.cand.size
    return _batch(lo, kind, size, plan.b0, plan.cand, sb, np.arange(m, dtype=np.int64),
                  plan.headers.reshape(-1), np.arange(m, dtype=np.int64) * native.HDR_STRIDE,
                  plan.hlen, blob, boff)


def encode_sub_word_batch(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
                          bit_reorder: int, threshold, abandon: Optional[Abandon],
                          clock: Dict) -> Batch:
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
    t = _tick(clock, "split_s", t, dev)
    lens = src.put(g.lens)
    inside = torch.arange(planes.shape[2], device=dev) < lens[:, None]  # [nb, pmax]
    flags = ((planes == planes[:, :, :1]) | ~inside).all(dim=2) & (lens > 0)
    flags_h = src.get(flags)
    t = _tick(clock, "kernels_s", t, dev)
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
    _tick(clock, "fetch_s", t, dev)
    none = np.zeros(0, np.int64)
    return Batch(lo, kind, size, b0, None, None, np.zeros(0, np.uint8), none, none,
                 np.ascontiguousarray(boff), blob)


def _layout(g: Geometry, batches: List[Batch], tail, prefix_len: int):
    """The output frame with the chunk-type and cumulative-size tables
    written behind ``prefix_len`` bytes, and the absolute start of plane
    ``b``'s cell of chunk ``c`` (``base[b] + starts[b, c]``)."""
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
    out = codec.frame(prefix_len + tbl_len + int(starts[:, -1].sum()))
    out[prefix_len : prefix_len + types.nbytes] = types.reshape(-1)
    out[prefix_len + types.nbytes : prefix_len + tbl_len] = cumulative.view(np.uint8).reshape(-1)
    return out, base.astype(np.int64), starts


def _tail_cells(tail):
    """The tail's cells as a copy of each plane's stored block: (sizes,
    offsets into the joined blob, blob)."""
    sizes = np.asarray(tail[1], dtype=np.int64)
    return sizes, np.cumsum(sizes) - sizes, np.concatenate(tail[2])


def splice(g: Geometry, batches: List[Batch], tail, prefix_len: int = 0) -> np.ndarray:
    """The container payload behind ``prefix_len`` bytes left for the
    caller's header, in one ``codec.frame``: chunk-type and cumulative-size
    tables, then each plane's cells in chunk order, every batch's cells
    written at their global offsets by one call to the native core
    (``native.splice_cells``), the tail's as one more.  ``tail`` is None or
    (types [num_buf], sizes [num_buf], stored blocks)."""
    out, base, starts = _layout(g, batches, tail, prefix_len)
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
    return out


def splice_plain(g: Geometry, batches: List[Batch], tail, prefix_len: int = 0) -> np.ndarray:
    """Plain Python version of :func:`splice`: the same buffer, cell by
    cell."""
    out, base, starts = _layout(g, batches, tail, prefix_len)
    for bt in batches:
        for b in range(g.num_buf):
            o = int(base[b] + starts[b, bt.lo])
            for c in range(bt.kind.shape[0]):
                kd, n, r = bt.kind[c, b], int(bt.size[c, b]), int(bt.boff[c, b])
                if kd == RLE:
                    out[o] = bt.b0[c, b]
                elif kd == RAW:
                    out[o : o + n] = bt.blob[r : r + n]
                else:
                    h = bt.hid[c, b]
                    hl = int(bt.hlen[h])
                    hdr = bt.hpool[bt.hoff[h] : bt.hoff[h] + hl]
                    out[o : o + hl] = hdr
                    out[o + hl : o + hl + 6] = bt.jump[c, b].astype("<u2").view(np.uint8)
                    out[o + hl + 6 : o + n] = bt.blob[r : r + n - hl - 6]
                o += n
    if tail is not None:
        sizes, offs, blob = _tail_cells(tail)
        for b in range(g.num_buf):
            o = int(base[b] + starts[b, -2])
            out[o : o + sizes[b]] = blob[offs[b] : offs[b] + sizes[b]]
    return out


def compress_payload(data, num_buf: int, bit_reorder: int, byte_reorder: int,
                     chunk_size: int, threshold: float = codec.DEFAULT_THRESHOLD,
                     check_th_after_percent: int = 0, shared_tables: bool = False,
                     device="cuda", prefix_len: int = 0) -> np.ndarray:
    """Compress ``data`` (a host uint8 array, or a uint8 tensor, read in
    place on its CUDA device) into the payload of either profile on
    ``device``; its bytes equal ``codec.compress_payload_numpy(...)``'s
    for the same arguments (``check_th_after_percent`` applies to the
    per-chunk profile only, as there).  Returns a ``codec.frame`` that
    holds ``prefix_len`` bytes for the caller's header, then the
    payload."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    last_timings.clear()
    if isinstance(data, torch.Tensor):
        n = int(data.numel())
    else:
        data = np.frombuffer(memoryview(data), dtype=np.uint8)
        n = data.size
    g = Geometry(n, num_buf, chunk_size, shared_tables, byte_reorder)
    if g.sub_word:
        last_timings.update(encoder="sub_word", kernels=())
    elif shared_tables:
        last_timings.update(encoder="huf_shared_encode", kernels=SHARED_KERNELS)
    else:
        last_timings.update(encoder="huf_pc_encode", kernels=PC_KERNELS)
    src = Source(data, g, device)
    tail_planes = None
    if src.tail.size:
        tail_planes = byte_group.split(src.tail, num_buf, byte_reorder, bit_reorder)

    def run(one):
        with kernels.recording() as events:
            batches = [one(lo, hi) for lo, hi in g.batches]
        last_timings["events"] = events
        return batches

    abandon = None if shared_tables else Abandon(g.n_chunks, check_th_after_percent, num_buf)
    shared = [None] * num_buf
    if g.sub_word:
        batches = run(lambda lo, hi: encode_sub_word_batch(
            src, g, lo, hi, byte_reorder, bit_reorder, threshold, abandon, last_timings))
    elif shared_tables:
        t0, up0 = time.perf_counter(), src.upload_s
        counts = sampled_counts(src, g, byte_reorder, bit_reorder, tail_planes)
        shared, live = codec.shared_tables_from_counts(counts, threshold, g.stride)
        # the sampled chunks' uploads (several batches of host input) count as upload
        last_timings["hist_s"] = time.perf_counter() - t0 - (src.upload_s - up0)
        hdrs = [b"" if t is None else t[2] for t in shared]
        hpool = np.frombuffer(b"".join(hdrs), np.uint8)
        hlen = np.asarray([len(h) for h in hdrs], dtype=np.int64)
        hoff = np.cumsum(hlen) - hlen
        tables = {}
        if 12 <= g.plane_bytes <= huf.HUF_BLOCKSIZE_MAX:  # else every cell is raw or RLE
            for b in range(num_buf):
                if live[b]:
                    lengths, vals, _, _ = shared[b]
                    tables[b] = src.put(huf_enc.pack_etable(vals, lengths))
        shared = [t if alive else None for t, alive in zip(shared, live)]
        batches = run(lambda lo, hi: encode_shared_batch(
            src, g, lo, hi, byte_reorder, bit_reorder, tables, hpool, hoff, hlen, threshold,
            last_timings))
    else:
        batches = run(lambda lo, hi: encode_pc_batch(
            src, g, lo, hi, byte_reorder, bit_reorder, threshold, abandon, last_timings))

    t2 = time.perf_counter()
    tail = None
    if tail_planes is not None:
        tail_types = np.zeros(num_buf, dtype=np.uint8)
        tail_sizes = np.zeros(num_buf, dtype=np.int64)
        tail_blobs = []
        for b, plane in enumerate(tail_planes):
            if shared_tables:
                comp = codec.compress_cell_shared(plane, shared[b])
            else:
                comp = None if abandon.planes[b] else native.huf_compress(plane)
            if comp is not None and len(comp) < plane.size * threshold:
                tail_types[b] = 1
                blob = np.frombuffer(comp, np.uint8)
            else:
                blob = plane
            tail_sizes[b] = blob.size
            tail_blobs.append(blob)
        tail = (tail_types, tail_sizes, tail_blobs)
    out = splice(g, batches, tail, prefix_len)
    last_timings["splice_s"] = time.perf_counter() - t2
    last_timings.update(upload_s=src.upload_s, upload_bytes=src.uploaded,
                        h2d_bytes=src.h2d, d2h_bytes=src.d2h, batches=len(batches))
    return out


def kernel_ms() -> Dict[str, float]:
    """Device milliseconds of the last CUDA compress by kernel name (the
    profile's two kernels, summed over batches), from the events that
    ``kernels.launch`` recorded around each launch; synchronises on
    them."""
    return kernels.elapsed_ms(last_timings.get("events", []),
                              last_timings.get("kernels", SHARED_KERNELS))
