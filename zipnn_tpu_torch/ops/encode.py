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
     counts, the host plan of each cell (:func:`plan_cells`: RLE, raw, or a
     Huffman table, in the golden encoder's order of checks), then
     ``huf_enc.huf_pc_encode`` over the 4 streams of every Huffman cell,
     each with its cell's table.

   One device-to-host copy brings the bit counts (and K8's flags); the
   host takes every cell's decision (:func:`decide`) and, per-chunk, the
   bounded threshold check (:class:`Abandon`); a second copy brings the
   bytes the container needs (:func:`fetch`): each Huffman stream's bytes
   and the raw cells.
4. **Tail and output**: the tail cell goes through the golden encoder's
   cell code on the host (``huf.compress``, or
   ``codec.compress_cell_shared``); the host writes the chunk tables and
   splices every plane's cells at their global offsets (:func:`splice`),
   so several batches stitch into one container.

On CPU tensors the kernels' plain versions run, so the same pipeline
encodes on the host for the tests.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .. import codec
from . import byte_group, const_scan, hist, huf_enc, kernels, transforms
from .entropy import fse, huf

RAW, RLE, HUF = 0, 1, 2
BATCH_BYTES = 512 << 20  # input bytes per device batch

# what the last compress spent, for callers that report it: the encoder
# that ran ("huf_shared_encode", "huf_pc_encode", or "golden" where
# ``codec.device_encodes`` routes the call to the golden encoder), the
# device kernels it launches ("kernels"), host-clock phase seconds
# (split_s, hist_s, plan_s, kernels_s, fetch_s, splice_s, upload_s), the
# input bytes uploaded (upload_bytes), every byte moved each way
# (h2d_bytes: the input's uploads, the tables and the fetch indices;
# d2h_bytes), the batch count and, on CUDA, the events recorded around
# each kernel launch
last_timings: Dict = {}

SHARED_KERNELS = ("const_scan_rows", "huf_shared_encode")
PC_KERNELS = ("hist_cells", "huf_pc_encode")


def batch_chunks(chunk_size: int, stride: int) -> int:
    """Full chunks per device batch: a multiple of the sampling stride, so
    every batch starts on a sampled chunk, with BATCH_BYTES of input at
    most (one stride at least)."""
    return max(stride, BATCH_BYTES // (chunk_size * stride) * stride)


class Geometry:
    """Chunks, tail, sampling stride (1 in the per-chunk profile) and
    batches of one buffer."""

    def __init__(self, n: int, num_buf: int, chunk_size: int, shared: bool = True):
        if chunk_size % (4 * num_buf):
            raise ValueError(f"chunk size {chunk_size}: the device encoder needs planes "
                             f"of whole 4-byte words (chunks of {4 * num_buf} bytes or more)")
        self.n, self.num_buf, self.chunk_size = n, num_buf, chunk_size
        self.full = n // chunk_size
        self.n_chunks = codec.num_chunks_for(n, chunk_size)
        self.stride = codec.shared_sample_stride(self.n_chunks) if shared else 1
        self.plane_bytes = chunk_size // num_buf
        self.seg = self.plane_bytes // 4  # bytes of each of a cell's 4 streams
        B = batch_chunks(chunk_size, self.stride)
        self.batches = [(lo, min(lo + B, self.full)) for lo in range(0, self.full, B)]


class Source:
    """The full chunks as int32 words ``[full, chunk_size / 4]`` on the
    device: a view of the caller's device tensor, or host bytes uploaded
    per batch (once, when one batch holds them all).  Counts the bytes it
    and the encoder move each way and the seconds the input's uploads
    take."""

    def __init__(self, data, g: Geometry, device: torch.device):
        self.device = device
        self.uploaded = self.h2d = self.d2h = 0
        self.upload_s = 0.0
        nfull = g.full * g.chunk_size
        self.words = self.host = None
        if isinstance(data, torch.Tensor) and data.device.type != "cpu":
            flat = data.reshape(-1).to(device)
            head = flat[:nfull]
            if head.storage_offset() % 4:
                head = head.clone()  # a copy on the device, to a word boundary
            self.words = head.view(torch.int32).view(g.full, g.chunk_size // 4)
            self.tail = flat[nfull:].cpu().numpy()
            self.d2h += self.tail.size
            return
        if isinstance(data, torch.Tensor):
            data = data.reshape(-1).numpy()
        flat = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
        self.host = flat[:nfull].reshape(g.full, g.chunk_size)
        self.tail = flat[nfull:]
        if len(g.batches) == 1:
            self.words = self._up(self.host)

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
        return t.view(torch.int32)

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

    def batch(self, lo: int, hi: int) -> torch.Tensor:
        if self.words is not None:
            return self.words[lo:hi]
        return self._up(self.host[lo:hi])

    def sample(self, lo: int, hi: int, stride: int) -> torch.Tensor:
        """Chunks lo, lo + stride, ... below hi."""
        if self.words is not None:
            return self.words[lo:hi:stride]
        return self._up(np.ascontiguousarray(self.host[lo:hi:stride]))


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
    header, or a header too long for the cell)."""
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
    order), their weight headers and [m, 256] tables."""

    rle: np.ndarray
    b0: np.ndarray
    cand: np.ndarray
    headers: List[bytes]
    tables: np.ndarray


def plan_cells(counts: np.ndarray, n: int, abandoned: np.ndarray) -> PcPlan:
    """Each cell's plan from its byte counts ([k, num_buf, 256]), in the
    order of checks of the golden ``huf.compress`` (the JAX package's
    ``_plan_cell``): a cell of 0 or more than ``HUF_BLOCKSIZE_MAX`` bytes
    is raw (a constant one too); one repeated byte is RLE; a cell whose
    largest count is at most ``(n >> 7) + 4``, or under 12 bytes, is raw;
    else :func:`cell_table` builds its table.  The cheap checks run
    vectorised over all cells, so only the cells that pass them pay for a
    table build.  Cells of ``abandoned`` planes are raw."""
    k, nb, _ = counts.shape
    rle = np.zeros((k, nb), dtype=bool)
    b0 = np.zeros((k, nb), dtype=np.uint8)
    cand, headers, tables = [], [], []
    if 0 < n <= huf.HUF_BLOCKSIZE_MAX:
        largest = counts.max(axis=2)
        live = ~abandoned[None, :]
        rle = (largest == n) & live
        b0 = counts.argmax(axis=2).astype(np.uint8)
        coded = live & ~rle & (largest > (n >> 7) + 4) & (n >= 12)
        flat = counts.reshape(k * nb, 256)
        for f in np.nonzero(coded.reshape(-1))[0]:
            t = cell_table(flat[f], n)
            if t is not None:
                cand.append(f)
                headers.append(t[0])
                tables.append(t[1])
    tables = np.stack(tables) if tables else np.zeros((0, 256), np.int16)
    return PcPlan(rle, b0, np.asarray(cand, dtype=np.int64), headers, tables)


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

    def apply(self, lo: int, kind: np.ndarray, size: np.ndarray, plane_bytes: int,
              threshold: float) -> None:
        if self.idx is None or self.idx < lo:
            return
        k = kind.shape[0]
        if self.idx >= lo + k:
            self.stored += size.sum(axis=0)
            return
        j = self.idx - lo + 1  # chunks of this batch up to the check
        stored = self.stored + size[:j].sum(axis=0)
        uncomp = np.full(kind.shape[1], (self.idx + 1) * plane_bytes, dtype=np.int64)
        flips = codec.check_abandon_planes(stored, uncomp, threshold)
        kind[j:, flips] = RAW
        size[j:, flips] = plane_bytes
        self.planes |= flips


@dataclass
class Batch:
    """One batch's decisions ([k, num_buf] ``kind``, ``size``, the RLE
    bytes ``b0``, the header index ``hid`` of each Huffman cell into
    ``headers``, its stream bytes ``sbytes`` [k, num_buf, 4]) and the bytes
    fetched for its cells: cell (c, b)'s Huffman streams or raw bytes from
    ``blob[boff[c, b]]``."""

    lo: int
    kind: np.ndarray
    size: np.ndarray
    b0: np.ndarray
    hid: np.ndarray
    headers: list
    sbytes: np.ndarray
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


def _batch(lo, kind, size, b0, cand, sb, hid, headers, blob, boff) -> Batch:
    k, nb = kind.shape
    hidk = np.full(k * nb, -1, dtype=np.int64)
    hidk[cand] = hid
    sbk = np.zeros((k * nb, 4), dtype=np.int64)
    sbk[cand] = sb
    return Batch(lo, kind, size, b0, hidk.reshape(k, nb), headers, sbk.reshape(k, nb, 4),
                 boff, blob)


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
                        bit_reorder: int, tables: Dict[int, torch.Tensor], headers,
                        threshold, clock: Dict) -> Batch:
    """Shared profile, pass 2 on chunks [lo, hi): split, K8, K7, the
    decisions, and the fetch of the bytes the container needs."""
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
    hlen = np.asarray([0 if h is None else len(h) for h in headers], dtype=np.int64)
    kind, size, sb = decide((flags_h >> 8).astype(bool), cand, dec[k * nb :], hlen[hid],
                            g.plane_bytes, threshold)
    blob, boff = fetch(src, planes, kind, cand, sb, rows)
    _tick(clock, "fetch_s", t, src.device)
    return _batch(lo, kind, size, (flags_h & 0xFF).astype(np.uint8), cand, sb, hid,
                  headers, blob, boff)


def encode_pc_batch(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
                    bit_reorder: int, threshold, abandon: Abandon, clock: Dict) -> Batch:
    """Per-chunk profile on chunks [lo, hi): split, the cell histograms
    and their fetch, the host plan, K7 over the Huffman cells' streams, the
    decisions and the threshold check, and the fetch of the bytes the
    container needs."""
    nb, pw = g.num_buf, g.plane_bytes // 4
    k = hi - lo
    planes, t = _split(src, g, lo, hi, byte_reorder, bit_reorder, clock)
    counts = src.get(hist.hist_cells(planes.view(k * nb, pw)))
    t = _tick(clock, "hist_s", t, src.device)
    plan = plan_cells(counts.reshape(k, nb, 256).astype(np.int64), g.plane_bytes,
                      abandon.planes)
    t = _tick(clock, "plan_s", t, src.device)
    rows, bits = [], np.zeros((0, 4), np.int32)
    if plan.cand.size:
        r, tb = huf_enc.huf_pc_encode(planes, src.put(plan.tables), g.seg,
                                      _streams(src.put(plan.cand), pw))
        rows = [r]
        bits = src.get(tb)
    t = _tick(clock, "kernels_s", t, src.device)
    hlen = np.asarray([len(h) for h in plan.headers], dtype=np.int64)
    kind, size, sb = decide(plan.rle, plan.cand, bits, hlen, g.plane_bytes, threshold)
    abandon.apply(lo, kind, size, g.plane_bytes, threshold)
    blob, boff = fetch(src, planes, kind, plan.cand, sb, rows)
    _tick(clock, "fetch_s", t, src.device)
    headers = [np.frombuffer(h, np.uint8) for h in plan.headers]
    return _batch(lo, kind, size, plan.b0, plan.cand, sb,
                  np.arange(plan.cand.size, dtype=np.int64), headers, blob, boff)


def splice(g: Geometry, batches: List[Batch], tail_types, tail_sizes,
           tail_blobs) -> memoryview:
    """The container payload: chunk-type and cumulative-size tables, then
    each plane's cells in chunk order, batches at their global offsets
    (a view of one buffer: the caller's join with the header is its only
    copy)."""
    nb, pb = g.num_buf, g.plane_bytes
    types = np.zeros((nb, g.n_chunks), dtype=np.uint8)
    sizes = np.zeros((nb, g.n_chunks), dtype=np.int64)
    for bt in batches:
        k = bt.kind.shape[0]
        types[:, bt.lo : bt.lo + k] = (bt.kind != RAW).T
        sizes[:, bt.lo : bt.lo + k] = bt.size.T
    if tail_blobs is not None:
        types[:, -1] = tail_types
        sizes[:, -1] = tail_sizes
    cumulative = np.cumsum(sizes, axis=1).astype("<u8")
    starts = np.zeros((nb, g.n_chunks + 1), dtype=np.int64)
    starts[:, 1:] = cumulative
    tbl_len = types.nbytes + cumulative.nbytes
    plane_base = tbl_len + np.concatenate([[0], np.cumsum(starts[:, -1])[:-1]])
    out = np.empty(tbl_len + int(starts[:, -1].sum()), dtype=np.uint8)
    out[: types.nbytes] = types.reshape(-1)
    out[types.nbytes : tbl_len] = cumulative.view(np.uint8).reshape(-1)
    for bt in batches:
        jump = bt.sbytes[:, :, :3].astype("<u2").view(np.uint8)  # [k, nb, 6]
        for b in range(nb):
            o = int(plane_base[b] + starts[b, bt.lo])
            for c in range(bt.kind.shape[0]):
                kd = bt.kind[c, b]
                r = int(bt.boff[c, b])
                if kd == RLE:
                    out[o] = bt.b0[c, b]
                    o += 1
                elif kd == RAW:
                    out[o : o + pb] = bt.blob[r : r + pb]
                    o += pb
                else:
                    hdr = bt.headers[bt.hid[c, b]]
                    hl = hdr.size
                    m = int(bt.sbytes[c, b].sum())
                    out[o : o + hl] = hdr
                    out[o + hl : o + hl + 6] = jump[c, b]
                    out[o + hl + 6 : o + hl + 6 + m] = bt.blob[r : r + m]
                    o += hl + 6 + m
    if tail_blobs is not None:
        for b in range(nb):
            o = int(plane_base[b] + starts[b, -2])
            out[o : o + tail_blobs[b].size] = tail_blobs[b]
    return memoryview(out)


def compress_payload(data, num_buf: int, bit_reorder: int, byte_reorder: int,
                     chunk_size: int, threshold: float = codec.DEFAULT_THRESHOLD,
                     check_th_after_percent: int = 0, shared_tables: bool = False,
                     device="cuda") -> memoryview:
    """Compress ``data`` (a host uint8 array, or a uint8 tensor, read in
    place on its CUDA device) into the payload of either profile on
    ``device``; its bytes equal ``codec.compress_payload_numpy(...)``'s
    for the same arguments (``check_th_after_percent`` applies to the
    per-chunk profile only, as there)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    last_timings.clear()
    last_timings["encoder"] = "huf_shared_encode" if shared_tables else "huf_pc_encode"
    last_timings["kernels"] = SHARED_KERNELS if shared_tables else PC_KERNELS
    if isinstance(data, torch.Tensor):
        n = int(data.numel())
    else:
        data = np.frombuffer(memoryview(data), dtype=np.uint8)
        n = data.size
    g = Geometry(n, num_buf, chunk_size, shared_tables)
    src = Source(data, g, device)
    tail_planes = None
    if src.tail.size:
        tail_planes = byte_group.split(src.tail, num_buf, byte_reorder, bit_reorder)

    def run(one):
        with kernels.recording() as events:
            batches = [one(lo, hi) for lo, hi in g.batches]
        last_timings["events"] = events
        return batches

    if shared_tables:
        t0, up0 = time.perf_counter(), src.upload_s
        counts = sampled_counts(src, g, byte_reorder, bit_reorder, tail_planes)
        shared, live = codec.shared_tables_from_counts(counts, threshold, g.stride)
        # the sampled chunks' uploads (several batches of host input) count as upload
        last_timings["hist_s"] = time.perf_counter() - t0 - (src.upload_s - up0)
        headers = [None if t is None else np.frombuffer(t[2], np.uint8) for t in shared]
        tables = {}
        if 12 <= g.plane_bytes <= huf.HUF_BLOCKSIZE_MAX:  # else every cell is raw or RLE
            for b in range(num_buf):
                if live[b]:
                    lengths, vals, _, _ = shared[b]
                    tables[b] = src.put(huf_enc.pack_etable(vals, lengths))
        batches = run(lambda lo, hi: encode_shared_batch(
            src, g, lo, hi, byte_reorder, bit_reorder, tables, headers, threshold,
            last_timings))

        def tail_cell(b, plane):
            return codec.compress_cell_shared(plane, shared[b] if live[b] else None)
    else:
        abandon = Abandon(g.n_chunks, check_th_after_percent, num_buf)
        batches = run(lambda lo, hi: encode_pc_batch(
            src, g, lo, hi, byte_reorder, bit_reorder, threshold, abandon, last_timings))

        def tail_cell(b, plane):
            return None if abandon.planes[b] else huf.compress(plane)

    t2 = time.perf_counter()
    tail_types = tail_sizes = tail_blobs = None
    if tail_planes is not None:
        tail_types = np.zeros(num_buf, dtype=np.uint8)
        tail_sizes = np.zeros(num_buf, dtype=np.int64)
        tail_blobs = []
        for b, plane in enumerate(tail_planes):
            comp = tail_cell(b, plane)
            if comp is not None and len(comp) < plane.size * threshold:
                tail_types[b] = 1
                blob = np.frombuffer(comp, np.uint8)
            else:
                blob = plane
            tail_sizes[b] = blob.size
            tail_blobs.append(blob)
    payload = splice(g, batches, tail_types, tail_sizes, tail_blobs)
    last_timings["splice_s"] = time.perf_counter() - t2
    last_timings.update(upload_s=src.upload_s, upload_bytes=src.uploaded,
                        h2d_bytes=src.h2d, d2h_bytes=src.d2h, batches=len(batches))
    return payload


def kernel_ms() -> Dict[str, float]:
    """Device milliseconds of the last CUDA compress by kernel name (the
    profile's two kernels, summed over batches), from the events that
    ``kernels.launch`` recorded around each launch; synchronises on
    them."""
    return kernels.elapsed_ms(last_timings.get("events", []),
                              last_timings.get("kernels", SHARED_KERNELS))
