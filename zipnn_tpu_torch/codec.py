"""Chunked byte-group + entropy container codec (PyTorch/CUDA port).

Turns a flat byte buffer into the ``.znn`` payload

```
[chunk-type table  uint8  [num_buf][num_chunks]]   0 = raw, 1 = Huffman
[cumulative sizes  uint64 [num_buf][num_chunks]]   per-plane running totals
[plane 0 compressed chunks ‖ plane 1 ‖ ...]        chunk order within plane
```

and back (layout per the reference C core, csrc/zipnn_core.c:105-153 writer
and :927-1028 reader; cumulative sizes are little-endian 64-bit).

Engines:

* ``numpy`` — pure-Python/numpy golden model (this module): compress and
  decompress on the host.
* ``cuda``  — decompress through the hand-written CUDA kernels
  (``ops.decode``) and compress on the card (``ops.encode``), both
  profiles, byte-identical to the golden encoder, at every chunk size
  (planes under one word by the encoder's sub-word route); the host steps
  between the kernels run in the native core (``native``).
* ``native`` — the native C++ host codec (``native``, the port's copy of
  the JAX package's core): compress and decompress on the host, both
  profiles, byte-identical to the golden encoder.

The golden encoder here is a copy of the JAX package's
``codec.compress_payload_numpy`` (both the per-chunk table profile and the
shared-table profile) and writes the same bytes for the same arguments.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from .errors import CorruptChunkError
from .ops import byte_group
from .ops.entropy import huf

DEFAULT_THRESHOLD = 0.95
HUF_CAP = 128 * 1024  # HUF block limit; planes larger than this store raw
ENGINES = ("numpy", "cuda", "native")

# Shared-table profile: table-build sampling (format policy).  At >= 512
# chunks a plane's Huffman table is built from every 8th chunk's plane
# only, and a plane whose sampled expected code length cannot beat the
# threshold is skipped wholesale ("hopeless": every cell raw, RLE still
# applies).  Below 512 chunks every chunk feeds the table.
SHARED_SAMPLE_MIN_CHUNKS = 512
SHARED_SAMPLE_STRIDE = 8


def shared_sample_stride(n_chunks: int) -> int:
    """Chunk stride for the shared-table histogram (1 = every chunk)."""
    return SHARED_SAMPLE_STRIDE if n_chunks >= SHARED_SAMPLE_MIN_CHUNKS else 1


def shared_plane_hopeless(
    count: np.ndarray, lengths: np.ndarray, threshold: float
) -> bool:
    """Plane-level skip rule, applied only when sampling is active: True
    when the sampled expected code length >= 8 * threshold bits per symbol.
    One IEEE-double expression, so the decision (and the container bytes)
    does not depend on the engine."""
    c = count.astype(np.int64)
    bits = float(int((c * lengths.astype(np.int64)).sum()))
    total = float(int(c.sum()))
    return bits >= threshold * 8.0 * total


def check_abandon_index(n_chunks: int, check_th_after_percent: int) -> Optional[int]:
    """Chunk index K at which the bounded threshold check runs.

    ``K = ceil(numChunks / percent)`` as the reference computes it
    (csrc/zipnn_core.c:423-424).  After coding chunks ``0..K`` of a plane,
    if the cumulative stored size exceeds ``threshold`` x the cumulative
    uncompressed size, the plane's later chunks are stored raw.  ``0``
    disables the check.  Returns None when disabled or when the check
    point is at/after the last chunk.
    """
    if not check_th_after_percent or check_th_after_percent <= 0:
        return None
    k = -(-n_chunks // check_th_after_percent)  # ceil, reference formula
    return k if k < n_chunks - 1 else None


def check_abandon_planes(
    stored: np.ndarray, uncomp: np.ndarray, threshold: float
) -> np.ndarray:
    """Plane-abandonment decision from the prefix cells' stored vs
    uncompressed byte totals ([num_buf] each), one IEEE-double expression
    so the container bytes do not depend on the engine."""
    return np.asarray(
        [float(int(s)) > float(int(u)) * threshold for s, u in zip(stored, uncomp)],
        dtype=bool,
    )


def effective_chunk(compression_chunk: int, num_buf: int) -> int:
    """fp8 (single-plane) chunks are capped at the 128 KB HUF block limit
    (reference zipnn.py:721)."""
    if num_buf == 1:
        return min(HUF_CAP, compression_chunk)
    return compression_chunk


def num_chunks_for(length: int, chunk_size: int) -> int:
    return (length + chunk_size - 1) // chunk_size


# ---------------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------------

def compress_payload_numpy(
    data: np.ndarray,
    num_buf: int,
    bit_reorder: int,
    byte_reorder: int,
    chunk_size: int,
    threshold: float = DEFAULT_THRESHOLD,
    check_th_after_percent: int = 0,
    shared_tables: bool = False,
    preset_shared=None,
) -> bytes:
    """Compress a flat uint8 buffer into the table+planes payload (no
    header).

    By default one Huffman table per (plane, chunk) cell — the profile the
    reference library writes.  ``shared_tables=True`` writes the
    shared-table profile: one <=8-bit table per byte plane, built from the
    plane's (sampled) histogram, its weight header repeated in every
    Huffman cell; ``preset_shared`` passes the (tables, live) pair in
    instead.  The shared profile ignores ``check_th_after_percent``.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    n_chunks = num_chunks_for(n, chunk_size)
    if shared_tables:
        shared, live = preset_shared or shared_plane_tables(
            data, num_buf, bit_reorder, byte_reorder, chunk_size, threshold
        )

    chunk_types = np.zeros((num_buf, n_chunks), dtype=np.uint8)
    chunk_sizes = np.zeros((num_buf, n_chunks), dtype=np.uint64)
    plane_blobs: List[List[bytes]] = [[] for _ in range(num_buf)]
    plane_sizes: List[List[int]] = [[] for _ in range(num_buf)]

    abandoned = np.zeros(num_buf, dtype=bool)
    check_idx = None if shared_tables else check_abandon_index(
        n_chunks, check_th_after_percent)
    for c in range(n_chunks):
        chunk = data[c * chunk_size : min((c + 1) * chunk_size, n)]
        planes = byte_group.split(chunk, num_buf, byte_reorder, bit_reorder)
        for b in range(num_buf):
            plane = planes[b]
            plane_sizes[b].append(plane.size)
            if shared_tables:
                comp = compress_cell_shared(plane, shared[b] if live[b] else None)
            else:
                comp = None if abandoned[b] else huf.compress(plane)
            if comp is not None and len(comp) < plane.size * threshold:
                chunk_types[b, c] = 1
                chunk_sizes[b, c] = len(comp)
                plane_blobs[b].append(comp)
            else:
                chunk_types[b, c] = 0
                chunk_sizes[b, c] = plane.size
                plane_blobs[b].append(plane.tobytes())
        if c == check_idx:
            stored = chunk_sizes[:, : c + 1].sum(axis=1)
            uncomp = np.asarray([sum(s[: c + 1]) for s in plane_sizes])
            abandoned |= check_abandon_planes(stored, uncomp, threshold)

    cumulative = np.cumsum(chunk_sizes, axis=1, dtype=np.uint64)
    parts = [chunk_types.tobytes(), cumulative.astype("<u8").tobytes()]
    for b in range(num_buf):
        parts.extend(plane_blobs[b])
    return b"".join(parts)


def shared_plane_tables(
    data: np.ndarray, num_buf: int, bit_reorder: int, byte_reorder: int,
    chunk_size: int, threshold: float,
):
    """Per-plane shared tables and live flags of the shared profile.

    Each plane's table comes from the byte histogram of its sampled chunks
    (every ``shared_sample_stride``-th, from chunk 0); with sampling on, a
    hopeless plane is not live.  Returns ([table or None] * num_buf,
    [bool] * num_buf), a table being ``huf.build_shared_table``'s tuple.
    """
    n = data.size
    n_chunks = num_chunks_for(n, chunk_size)
    stride = shared_sample_stride(n_chunks)
    counts = np.zeros((num_buf, 256), dtype=np.int64)
    for c in range(0, n_chunks, stride):
        chunk = data[c * chunk_size : min((c + 1) * chunk_size, n)]
        for b, plane in enumerate(
            byte_group.split(chunk, num_buf, byte_reorder, bit_reorder)
        ):
            if plane.size:
                counts[b] += np.bincount(plane, minlength=256)
    return shared_tables_from_counts(counts, threshold, stride)


def shared_tables_from_counts(counts: np.ndarray, threshold: float, stride: int):
    """Per-plane shared tables and live flags from the sampled counts
    ([num_buf, 256]): a plane without a table is not live, and with
    sampling on (``stride > 1``) neither is a hopeless one.  The same
    counts give the same (tables, live) pair whichever encoder summed
    them."""
    shared, live = [], []
    for count in counts:
        count = count.astype(np.int64)
        t = huf.build_shared_table(count) if count.sum() else None
        alive = t is not None
        if alive and stride > 1:
            alive = not shared_plane_hopeless(count, t[0], threshold)
        shared.append(t)
        live.append(alive)
    return shared, live


def compress_cell_shared(plane: np.ndarray, table) -> Optional[bytes]:
    """One cell of the shared profile: RLE for a single-symbol cell, the
    shared table otherwise; None (store raw) when the table is missing or
    lacks a code for a byte of the cell."""
    n = plane.size
    if n == 0:
        return None
    count = np.bincount(plane, minlength=256)
    if int(count.max()) == n:
        return bytes(plane[:1])  # 1-byte RLE block
    if table is None:
        return None
    lengths, vals, header, _ = table
    if int(lengths[plane].min()) == 0:
        # sampled table: the cell holds a byte the sample never saw
        return None
    return huf.compress_with_table(plane, lengths, vals, header)


# ---------------------------------------------------------------------------
# frames: bytes objects filled in place
# ---------------------------------------------------------------------------

def frame(n: int) -> np.ndarray:
    """A writable uint8 array over the storage of a new ``bytes`` object of
    ``n`` bytes, which the array keeps alive; :func:`frame_bytes` gives the
    ``bytes`` back once it is filled.  This is the C API's way to build a
    ``bytes`` in place (``PyBytes_FromStringAndSize(NULL, n)``, then writes
    through ``PyBytes_AsString``), so an encoder can write a container into
    the object that it returns, with no copy: fill the array before the
    ``bytes`` is hashed or shared, and write to it no more after."""
    api = ctypes.pythonapi
    api.PyBytes_FromStringAndSize.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
    api.PyBytes_FromStringAndSize.restype = ctypes.py_object
    api.PyBytes_AsString.argtypes = [ctypes.py_object]
    api.PyBytes_AsString.restype = ctypes.c_void_p
    obj = api.PyBytes_FromStringAndSize(None, n)
    store = (ctypes.c_uint8 * n).from_address(api.PyBytes_AsString(obj))
    store.frame = obj
    return np.frombuffer(store, dtype=np.uint8)


def frame_bytes(a: np.ndarray) -> bytes:
    """The ``bytes`` object under ``a``, an array from :func:`frame` or a
    view of one."""
    while not hasattr(a, "frame"):
        a = a.base
    return a.frame


class _Payload:
    """A payload that :func:`start_payload` computed whole (engines
    ``numpy`` and ``native``)."""

    __slots__ = ("buf",)

    def __init__(self, buf):
        self.buf = buf


def start_payload(
    data,
    num_buf: int,
    bit_reorder: int,
    byte_reorder: int,
    chunk_size: int,
    threshold: float = DEFAULT_THRESHOLD,
    engine: str = "cuda",
    check_th_after_percent: int = 0,
    shared_tables: bool = False,
    device="cuda",
    prefix_len: int = 0,
    between=None,
):
    """The first half of :func:`compress_payload`, for a writer that
    overlaps containers: on ``cuda``, ``ops.encode.start`` (kernels queued,
    every cell decided and written on the card; ``between`` called once,
    after the first launch and before the first host sync); the other
    engines compute the whole payload here (``between`` called first).
    :func:`finish_payload` gives the result."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "cuda":
        from .ops import encode  # noqa: PLC0415

        return encode.start(
            data, num_buf, bit_reorder, byte_reorder, chunk_size, threshold,
            check_th_after_percent=check_th_after_percent, shared_tables=shared_tables,
            device=device, prefix_len=prefix_len, between=between,
        )
    if between is not None:
        between()
    if engine == "native":
        from . import native  # noqa: PLC0415

        if shared_tables:
            payload = native.compress_payload_shared(
                data, num_buf, bit_reorder, byte_reorder, chunk_size, threshold)
        else:
            payload = native.compress_payload(
                data, num_buf, bit_reorder, byte_reorder, chunk_size, threshold,
                check_th_after_percent=check_th_after_percent)
    else:
        payload = compress_payload_numpy(
            np.asarray(data), num_buf, bit_reorder, byte_reorder, chunk_size, threshold,
            check_th_after_percent=check_th_after_percent,
            shared_tables=shared_tables,
        )
        if not prefix_len:
            return _Payload(payload)
    buf = frame(prefix_len + len(payload))
    buf[prefix_len:] = np.frombuffer(payload, np.uint8)
    return _Payload(buf if prefix_len else frame_bytes(buf))


def finish_payload(started, alloc=frame):
    """The result of a :func:`start_payload`: on ``cuda``,
    ``ops.encode.finish`` (the tail cells, the output from ``alloc``, the
    tables and the payload fetched from the card into it); else the
    payload computed at the start."""
    if isinstance(started, _Payload):
        return started.buf
    from .ops import encode  # noqa: PLC0415

    return encode.finish(started, alloc)


def compress_payload(
    data,
    num_buf: int,
    bit_reorder: int,
    byte_reorder: int,
    chunk_size: int,
    threshold: float = DEFAULT_THRESHOLD,
    engine: str = "cuda",
    check_th_after_percent: int = 0,
    shared_tables: bool = False,
    device="cuda",
    prefix_len: int = 0,
):
    """Engine-dispatched payload compress: ``finish_payload(start_payload(
    ...))``.

    ``cuda``: ``data`` is a host uint8 array or a uint8 tensor, read in
    place on its CUDA device, and ``ops.encode`` encodes it on ``device``;
    ``numpy`` and ``native``: ``data`` is a host uint8 array.  With
    ``prefix_len`` 0 the result is the payload as ``bytes``; else a
    :func:`frame` of ``prefix_len`` bytes left for the caller's container
    header, then the payload (:func:`frame_bytes` gives the ``bytes``
    once the header is in).  The ``cuda`` engine writes the payload into
    the frame in place; the ``native`` engine copies it there from the
    core's worst-case buffer, and the golden encoder's is copied in, so a
    frame holds only its own bytes.
    """
    out = finish_payload(start_payload(
        data, num_buf, bit_reorder, byte_reorder, chunk_size, threshold, engine,
        check_th_after_percent, shared_tables, device, prefix_len))
    if engine == "cuda" and not prefix_len:
        return frame_bytes(out)
    return out


# ---------------------------------------------------------------------------
# decompress
# ---------------------------------------------------------------------------

def parse_tables(
    payload, num_buf: int, n_chunks: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Parse chunk-type + cumulative-size tables.

    Returns (types [num_buf, n_chunks], start_offsets [num_buf, n_chunks+1]
    relative to each plane's data region, data_start offset in payload).
    """
    mv = memoryview(payload)
    t_len = num_buf * n_chunks
    s_len = num_buf * n_chunks * 8
    if len(mv) < t_len + s_len:
        raise CorruptChunkError("payload shorter than its chunk tables")
    types = np.frombuffer(mv[:t_len], dtype=np.uint8).reshape(num_buf, n_chunks).copy()
    cumulative = (
        np.frombuffer(mv[t_len : t_len + s_len], dtype="<u8")
        .reshape(num_buf, n_chunks)
        .astype(np.int64)
    )
    starts = np.zeros((num_buf, n_chunks + 1), dtype=np.int64)
    starts[:, 1:] = cumulative
    return types, starts, t_len + s_len


def plane_chunk_lengths(
    orig_size: int, chunk_size: int, num_buf: int, byte_reorder: int
) -> np.ndarray:
    """Uncompressed length of every (plane, chunk) cell, [num_buf, n_chunks]:
    full chunks give ``chunk_size // num_buf`` per plane, and the last
    chunk's remainder goes one byte at a time to the leading planes
    (zipnn_core.c:914-928, 1006-1028).  A full chunk smaller than a
    value (1-byte chunks of bf16, fp16, fp32; 2-byte chunks of fp32) is
    split as the last one is: that is what the encoder writes, where the
    reference's reader expects ``chunk_size // num_buf`` and refuses the
    container."""
    n_chunks = num_chunks_for(orig_size, chunk_size)
    out = np.zeros((num_buf, max(n_chunks, 0)), dtype=np.int64)
    if n_chunks == 0:
        return out
    if chunk_size % num_buf:
        out[:, :-1] = np.asarray(
            byte_group.plane_lengths(chunk_size, num_buf, byte_reorder))[:, None]
    else:
        out[:, :-1] = chunk_size // num_buf
    last = orig_size - chunk_size * (n_chunks - 1)
    out[:, -1] = byte_group.plane_lengths(last, num_buf, byte_reorder)
    return out


def decompress_payload_numpy(
    payload,
    num_buf: int,
    bit_reorder: int,
    byte_reorder: int,
    chunk_size: int,
    orig_size: int,
) -> np.ndarray:
    """Decompress the table+planes payload back to a flat uint8 buffer."""
    n_chunks = num_chunks_for(orig_size, chunk_size)
    out = np.empty(orig_size, dtype=np.uint8)
    if n_chunks == 0:
        return out

    types, starts, data_start = parse_tables(payload, num_buf, n_chunks)
    decomp_lens = plane_chunk_lengths(orig_size, chunk_size, num_buf, byte_reorder)
    mv = memoryview(payload)

    # plane data regions are laid out back to back
    plane_base = np.zeros(num_buf, dtype=np.int64)
    for b in range(1, num_buf):
        plane_base[b] = plane_base[b - 1] + starts[b - 1, n_chunks]

    for c in range(n_chunks):
        chunk_len = min(chunk_size, orig_size - c * chunk_size)
        planes = []
        for b in range(num_buf):
            lo = data_start + plane_base[b] + starts[b, c]
            hi = data_start + plane_base[b] + starts[b, c + 1]
            blob = mv[lo:hi]
            want = int(decomp_lens[b, c])
            if types[b, c] == 0:
                if hi - lo != want:
                    raise CorruptChunkError(
                        f"raw size mismatch: {hi - lo} != {want}", plane=b, chunk=c
                    )
                planes.append(np.frombuffer(blob, dtype=np.uint8))
            elif types[b, c] == 1:
                try:
                    planes.append(huf.decompress(blob, want))
                except ValueError as exc:
                    raise CorruptChunkError(str(exc), plane=b, chunk=c) from exc
            else:
                raise CorruptChunkError(
                    f"unknown chunk type {types[b, c]}", plane=b, chunk=c
                )
        byte_group.combine(
            planes,
            chunk_len,
            num_buf,
            byte_reorder,
            bit_reorder,
            out=out[c * chunk_size : c * chunk_size + chunk_len],
        )
    return out


def decompress_payload(
    payload,
    num_buf: int,
    bit_reorder: int,
    byte_reorder: int,
    chunk_size: int,
    orig_size: int,
    engine: str = "cuda",
    device="cuda",
):
    """Engine-dispatched payload decompress.

    ``numpy`` and ``native`` return a host uint8 array.  ``cuda`` returns
    a uint8 torch tensor on ``device`` holding ``orig_size`` bytes (the
    card unless the caller passes ``device="cpu"``, where the kernels'
    plain versions run).
    """
    if engine == "numpy":
        return decompress_payload_numpy(
            payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size
        )
    if engine == "native":
        from . import native  # noqa: PLC0415

        try:
            return native.decompress_payload(
                payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size)
        except RuntimeError:
            # the golden decoder names the corrupt (plane, chunk)
            decompress_payload_numpy(
                payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size)
            raise
    if engine == "cuda":
        from .ops import decode  # noqa: PLC0415

        return decode.decompress_payload(
            payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size,
            device=device,
        )
    raise ValueError(f"unknown engine {engine!r}")
