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
  (``ops.decode``); compress uses the golden encoder until the encode
  kernels are ported.

The golden encoder here is a copy of the JAX package's
``codec.compress_payload_numpy`` (per-chunk table profile) and writes the
same bytes for the same arguments.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .errors import CorruptChunkError
from .ops import byte_group
from .ops.entropy import huf

DEFAULT_THRESHOLD = 0.95
HUF_CAP = 128 * 1024  # HUF block limit; planes larger than this store raw
ENGINES = ("numpy", "cuda")


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
) -> bytes:
    """Compress a flat uint8 buffer into the table+planes payload (no
    header), one Huffman table per (plane, chunk) cell — the profile the
    reference library writes."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    n_chunks = num_chunks_for(n, chunk_size)

    chunk_types = np.zeros((num_buf, n_chunks), dtype=np.uint8)
    chunk_sizes = np.zeros((num_buf, n_chunks), dtype=np.uint64)
    plane_blobs: List[List[bytes]] = [[] for _ in range(num_buf)]
    plane_sizes: List[List[int]] = [[] for _ in range(num_buf)]

    abandoned = np.zeros(num_buf, dtype=bool)
    check_idx = check_abandon_index(n_chunks, check_th_after_percent)
    for c in range(n_chunks):
        chunk = data[c * chunk_size : min((c + 1) * chunk_size, n)]
        planes = byte_group.split(chunk, num_buf, byte_reorder, bit_reorder)
        for b in range(num_buf):
            plane = planes[b]
            plane_sizes[b].append(plane.size)
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


def compress_payload(
    data: np.ndarray,
    num_buf: int,
    bit_reorder: int,
    byte_reorder: int,
    chunk_size: int,
    threshold: float = DEFAULT_THRESHOLD,
    engine: str = "cuda",
    check_th_after_percent: int = 0,
) -> bytes:
    """Engine-dispatched payload compress.  Both engines run the golden
    encoder: the encode kernels are not ported yet (ROADMAP queue 2)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return compress_payload_numpy(
        data, num_buf, bit_reorder, byte_reorder, chunk_size, threshold,
        check_th_after_percent=check_th_after_percent,
    )


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
    (zipnn_core.c:914-928, 1006-1028)."""
    n_chunks = num_chunks_for(orig_size, chunk_size)
    out = np.zeros((num_buf, max(n_chunks, 0)), dtype=np.int64)
    if n_chunks == 0:
        return out
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

    ``numpy`` returns a host uint8 array.  ``cuda`` returns a uint8 torch
    tensor on ``device`` holding ``orig_size`` bytes (the card unless the
    caller passes ``device="cpu"``, where the kernels' plain versions run).
    """
    if engine == "numpy":
        return decompress_payload_numpy(
            payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size
        )
    if engine == "cuda":
        from .ops import decode  # noqa: PLC0415

        return decode.decompress_payload(
            payload, num_buf, bit_reorder, byte_reorder, chunk_size, orig_size,
            device=device,
        )
    raise ValueError(f"unknown engine {engine!r}")
