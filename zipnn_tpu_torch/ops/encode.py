"""Compress a buffer with the shared-table profile on the card.

The counterpart of the JAX package's device encode
(``jax_codec.plan_fast_encode``, its ``_assemble`` and
``fast_encode_payload_batched``), reduced to what the format needs.  The
container it returns equals the golden encoder's
(``codec.compress_payload_numpy(..., shared_tables=True)``) byte for
byte:

1. **Geometry**: the full chunks, the ragged tail, the sampling stride
   (``codec.shared_sample_stride``) and chunk-range batches, each a
   multiple of the stride (:func:`batch_chunks`).
2. **Pass 1, the tables**: the per-plane byte histogram of the sampled
   chunks (every ``stride``-th chunk from 0, and the tail cell when its
   index is on stride), split and counted on the device, summed in int64;
   then ``codec.shared_tables_from_counts``.
3. **Pass 2, per batch**: the batch's words (a view of the caller's CUDA
   tensor, or uploaded), the byte-plane split
   (``transforms.split_device``), kernel K8 (``const_scan.const_scan_rows``)
   over every (chunk, plane) row, and kernel K7
   (``huf_enc.huf_shared_encode``) over the 4 streams of every cell of
   each live plane.  One device-to-host copy brings the RLE flags and bit
   counts; the host takes every cell's decision (:func:`decide`); a second
   copy brings the bytes the container needs: each Huffman stream's bytes
   and the raw cells.
4. **Tail and output**: the tail cell goes through the golden
   ``codec.compress_cell_shared`` on the host; the host writes the chunk
   tables and splices every plane's cells at their global offsets, so
   several batches stitch into one container.

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
from . import byte_group, const_scan, huf_enc, kernels, transforms
from .entropy import huf

RAW, RLE, HUF = 0, 1, 2
BATCH_BYTES = 512 << 20  # input bytes per device batch

# what the last device compress spent, for callers that report it: the
# encoder that ran ("huf_shared_encode"), host-clock phase seconds
# (split_s, hist_s, kernels_s, fetch_s, splice_s, upload_s), the input
# bytes uploaded (upload_bytes), every byte moved each way (h2d_bytes:
# the input's uploads, the tables and the fetch indices; d2h_bytes), the
# batch count and, on CUDA, the events recorded around each K8 and K7
# launch
last_timings: Dict = {}


def batch_chunks(chunk_size: int, stride: int) -> int:
    """Full chunks per device batch: a multiple of the sampling stride, so
    every batch starts on a sampled chunk, with BATCH_BYTES of input at
    most (one stride at least)."""
    return max(stride, BATCH_BYTES // (chunk_size * stride) * stride)


class Geometry:
    """Chunks, tail, sampling stride and batches of one buffer."""

    def __init__(self, n: int, num_buf: int, chunk_size: int):
        if chunk_size % (4 * num_buf):
            raise ValueError(f"chunk size {chunk_size}: the device encoder needs planes "
                             f"of whole 4-byte words (chunks of {4 * num_buf} bytes or more)")
        self.n, self.num_buf, self.chunk_size = n, num_buf, chunk_size
        self.full = n // chunk_size
        self.n_chunks = codec.num_chunks_for(n, chunk_size)
        self.stride = codec.shared_sample_stride(self.n_chunks)
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


def sampled_counts(src: Source, g: Geometry, byte_reorder: int, bit_reorder: int,
                   tail_planes) -> np.ndarray:
    """Pass 1: [num_buf, 256] int64 byte counts of the sampled cells."""
    nb = g.num_buf
    counts = torch.zeros((nb, 256), dtype=torch.int64, device=src.device)
    for lo, hi in g.batches:
        planes = transforms.split_device(src.sample(lo, hi, g.stride), nb,
                                         byte_reorder, bit_reorder)
        for b in range(nb):
            counts[b] += torch.bincount(
                planes[:, b].contiguous().view(torch.uint8).reshape(-1), minlength=256)
    out = counts.cpu().numpy()
    if src.device.type == "cuda":
        src.d2h += out.nbytes
    if tail_planes is not None and g.full % g.stride == 0:
        for b, plane in enumerate(tail_planes):  # the tail cell is on stride
            if plane.size:
                out[b] += np.bincount(plane, minlength=256)
    return out


def decide(flags: np.ndarray, bits: Dict[int, np.ndarray], hlen: np.ndarray,
           plane_bytes: int, threshold: float):
    """Each full-chunk cell's kind and stored size, as the golden
    ``compress_cell_shared`` + ``huf.compress_with_table`` + threshold
    decide them.

    ``flags``: K8's [k, num_buf] ``b0 | const << 8``; ``bits``: K7's
    [k, 4] ``total_bits`` of each plane it ran on (live planes whose cells
    the HUF block size limits allow).  Returns (kind, size, sbytes): kind
    and size [k, num_buf], stream bytes [k, num_buf, 4].  A constant cell
    is RLE; else a cell is Huffman when its plane ran K7, no stream met an
    uncoded byte, every stream holds 1..65535 bytes and the block is
    shorter than ``plane_bytes - 1`` and than ``plane_bytes * threshold``;
    else raw.  Every block, RLE too, must beat the threshold.
    """
    k, nb = flags.shape
    limit = plane_bytes * threshold
    const = (flags >> 8).astype(bool)
    kind = np.full((k, nb), RAW, dtype=np.uint8)
    size = np.full((k, nb), plane_bytes, dtype=np.int64)
    sbytes = np.zeros((k, nb, 4), dtype=np.int64)
    rle = const & (1 < limit)
    kind[rle] = RLE
    size[rle] = 1
    for b, tb in bits.items():
        tb = tb.astype(np.int64)
        sb = ((tb & 0x3FFFFFFF) + 7) // 8
        comp = hlen[b] + 6 + sb.sum(axis=1)
        ok = (~const[:, b] & ~((tb >> 30) & 1).any(axis=1)
              & ((sb >= 1) & (sb <= 65535)).all(axis=1)
              & (comp < plane_bytes - 1) & (comp < limit))
        kind[ok, b] = HUF
        size[ok, b] = comp[ok]
        sbytes[:, b] = sb
    return kind, size, sbytes


@dataclass
class Batch:
    """One batch's decisions ([k, num_buf] arrays from :func:`decide`, the
    RLE bytes ``b0``) and the bytes fetched for its cells: ``blob`` holds
    each plane's Huffman streams from ``huf_off[plane]``, then the raw
    cells from ``raw_off`` in ``raw_idx`` order."""

    lo: int
    kind: np.ndarray
    size: np.ndarray
    sbytes: np.ndarray
    b0: np.ndarray
    blob: np.ndarray
    huf_off: Dict[int, int]
    raw_off: int
    raw_idx: np.ndarray


def encode_batch(src: Source, g: Geometry, lo: int, hi: int, byte_reorder: int,
                 bit_reorder: int, tables: Dict[int, torch.Tensor], hlen, threshold,
                 clock: Dict) -> Batch:
    """Pass 2 on chunks [lo, hi): split, K8, K7, the decisions, and the
    fetch of the bytes the container needs."""
    dev = src.device
    nb, pw = g.num_buf, g.plane_bytes // 4
    k = hi - lo
    words = src.batch(lo, hi)
    t1 = time.perf_counter()
    planes = transforms.split_device(words, nb, byte_reorder, bit_reorder)
    _sync(dev)
    t2 = time.perf_counter()
    flags = const_scan.const_scan_rows(planes.view(k * nb, pw))
    cells = torch.arange(k, dtype=torch.int64, device=dev)[:, None] * nb
    quarter = torch.arange(4, dtype=torch.int64, device=dev) * (pw // 4)
    rows, bits = {}, {}
    for b, table in tables.items():
        streams = ((cells + b) * pw + quarter).reshape(-1)
        rows[b], bits[b] = huf_enc.huf_shared_encode(planes, table, g.seg, streams)
    _sync(dev)
    t3 = time.perf_counter()
    dec = torch.cat([flags] + list(bits.values())).cpu().numpy()
    flags_h = dec[: k * nb].reshape(k, nb)
    bits_h = {b: dec[k * nb + 4 * k * i : k * nb + 4 * k * (i + 1)].reshape(k, 4)
              for i, b in enumerate(bits)}
    kind, size, sbytes = decide(flags_h, bits_h, hlen, g.plane_bytes, threshold)

    # the bytes the container needs: Huffman streams, then raw cells
    parts, huf_off, pos = [], {}, 0
    for b, r in rows.items():
        cs = np.nonzero(kind[:, b] == HUF)[0]
        if not cs.size:
            continue
        sb = sbytes[cs, b].reshape(-1)
        width = int(sb.max())
        sel = src.put((cs[:, None] * 4 + np.arange(4)).reshape(-1))
        got = r.view(torch.uint8)[:, :width].index_select(0, sel)
        keep = torch.arange(width, device=dev) < src.put(sb)[:, None]
        parts.append(got[keep])
        huf_off[b] = pos
        pos += int(sb.sum())
    raw_c, raw_b = np.nonzero(kind == RAW)
    raw_idx = np.full((k, nb), -1, dtype=np.int64)
    raw_idx[raw_c, raw_b] = np.arange(raw_c.size)
    if raw_c.size:
        pick = planes[src.put(raw_c), src.put(raw_b)]
        parts.append(pick.reshape(-1).view(torch.uint8))
    blob = (torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.uint8))
    if dev.type == "cuda":
        src.d2h += dec.nbytes + blob.nbytes
    t4 = time.perf_counter()
    for key, dt in (("split_s", t2 - t1), ("kernels_s", t3 - t2), ("fetch_s", t4 - t3)):
        clock[key] = clock.get(key, 0.0) + dt
    return Batch(lo, kind, size, sbytes, (flags_h & 0xFF).astype(np.uint8), blob,
                 huf_off, pos, raw_idx)


def splice(g: Geometry, batches: List[Batch], headers, tail_types, tail_sizes,
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
            hdr = headers[b]
            hl = 0 if hdr is None else hdr.size
            o = int(plane_base[b] + starts[b, bt.lo])
            h = bt.huf_off.get(b, 0)
            for c in range(bt.kind.shape[0]):
                kd = bt.kind[c, b]
                if kd == RLE:
                    out[o] = bt.b0[c, b]
                    o += 1
                elif kd == RAW:
                    r = bt.raw_off + int(bt.raw_idx[c, b]) * pb
                    out[o : o + pb] = bt.blob[r : r + pb]
                    o += pb
                else:
                    m = int(bt.sbytes[c, b].sum())
                    out[o : o + hl] = hdr
                    out[o + hl : o + hl + 6] = jump[c, b]
                    out[o + hl + 6 : o + hl + 6 + m] = bt.blob[h : h + m]
                    h += m
                    o += hl + 6 + m
    if tail_blobs is not None:
        for b in range(nb):
            o = int(plane_base[b] + starts[b, -2])
            out[o : o + tail_blobs[b].size] = tail_blobs[b]
    return memoryview(out)


def compress_payload(data, num_buf: int, bit_reorder: int, byte_reorder: int,
                     chunk_size: int, threshold: float = codec.DEFAULT_THRESHOLD,
                     device="cuda") -> memoryview:
    """Compress ``data`` (a host uint8 array, or a uint8 tensor, read in
    place on its CUDA device) into the shared-table payload on ``device``;
    its bytes equal ``codec.compress_payload_numpy(...,
    shared_tables=True)``'s."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    last_timings.clear()
    last_timings["encoder"] = "huf_shared_encode"
    if isinstance(data, torch.Tensor):
        n = int(data.numel())
    else:
        data = np.frombuffer(memoryview(data), dtype=np.uint8)
        n = data.size
    g = Geometry(n, num_buf, chunk_size)
    src = Source(data, g, device)
    t0, up0 = time.perf_counter(), src.upload_s
    tail_planes = None
    if src.tail.size:
        tail_planes = byte_group.split(src.tail, num_buf, byte_reorder, bit_reorder)
    counts = sampled_counts(src, g, byte_reorder, bit_reorder, tail_planes)
    shared, live = codec.shared_tables_from_counts(counts, threshold, g.stride)
    # the sampled chunks' uploads (several batches of host input) count as upload
    last_timings["hist_s"] = time.perf_counter() - t0 - (src.upload_s - up0)
    headers = [None if t is None else np.frombuffer(t[2], np.uint8) for t in shared]
    hlen = np.asarray([0 if h is None else h.size for h in headers], dtype=np.int64)
    tables = {}
    if 12 <= g.plane_bytes <= huf.HUF_BLOCKSIZE_MAX:  # else every cell is raw or RLE
        for b in range(num_buf):
            if live[b]:
                lengths, vals, _, _ = shared[b]
                tables[b] = src.put(huf_enc.pack_etable(vals, lengths))

    with kernels.recording() as events:
        batches = [encode_batch(src, g, lo, hi, byte_reorder, bit_reorder, tables,
                                hlen, threshold, last_timings) for lo, hi in g.batches]
    last_timings["events"] = events
    t2 = time.perf_counter()
    tail_types = tail_sizes = tail_blobs = None
    if tail_planes is not None:
        tail_types = np.zeros(num_buf, dtype=np.uint8)
        tail_sizes = np.zeros(num_buf, dtype=np.int64)
        tail_blobs = []
        for b, plane in enumerate(tail_planes):
            comp = codec.compress_cell_shared(plane, shared[b] if live[b] else None)
            if comp is not None and len(comp) < plane.size * threshold:
                tail_types[b] = 1
                blob = np.frombuffer(comp, np.uint8)
            else:
                blob = plane
            tail_sizes[b] = blob.size
            tail_blobs.append(blob)
    payload = splice(g, batches, headers, tail_types, tail_sizes, tail_blobs)
    last_timings["splice_s"] = time.perf_counter() - t2
    last_timings.update(upload_s=src.upload_s, upload_bytes=src.uploaded,
                        h2d_bytes=src.h2d, d2h_bytes=src.d2h, batches=len(batches))
    return payload


def kernel_ms() -> Dict[str, float]:
    """Device milliseconds of the last CUDA compress by kernel name (K8
    and K7, summed over batches), from the events that ``kernels.launch``
    recorded around each launch; synchronises on them."""
    return kernels.elapsed_ms(last_timings.get("events", []),
                              ("const_scan_rows", "huf_shared_encode"))
