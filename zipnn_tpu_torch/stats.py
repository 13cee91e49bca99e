"""Structured compression statistics and profiler spans, the port's copy
of the JAX package's observability layer.

``ZipNN.last_stats`` holds a :class:`CodecStats` for the last compress or
decompress.  :func:`frame_stats` and :func:`file_stats` read a ``.znn``
frame or file without decompressing it: header fields, per-plane
chunk-type histograms (raw / RLE / Huffman) and stored sizes.
:func:`trace` records a ``torch.profiler`` trace (host spans, and the
card's kernels and copies when CUDA is available) of a codec region;
:func:`phase` names the codec's host-visible phases inside it.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .core import dtypes
from .core.header import HEADER_LEN, Header


@dataclass
class CodecStats:
    """One codec operation's worth of numbers."""

    op: str = ""  # "compress" | "decompress"
    original_bytes: int = 0
    compressed_bytes: int = 0
    seconds: float = 0.0
    engine: str = ""
    dtype: str = ""
    chunk_size: int = 0

    @property
    def ratio(self) -> float:
        return self.compressed_bytes / self.original_bytes if self.original_bytes else 0.0

    @property
    def saved_percent(self) -> float:
        return 100.0 * (1.0 - self.ratio)

    @property
    def throughput_GBps(self) -> float:
        return self.original_bytes / self.seconds / 1e9 if self.seconds > 0 else 0.0

    def as_dict(self) -> Dict:
        return {
            "op": self.op,
            "original_bytes": self.original_bytes,
            "compressed_bytes": self.compressed_bytes,
            "ratio": round(self.ratio, 6),
            "saved_percent": round(self.saved_percent, 3),
            "seconds": round(self.seconds, 6),
            "throughput_GBps": round(self.throughput_GBps, 4),
            "engine": self.engine,
            "dtype": self.dtype,
            "chunk_size": self.chunk_size,
        }


@dataclass
class PlaneStats:
    plane: int
    raw_chunks: int = 0
    rle_chunks: int = 0
    huffman_chunks: int = 0
    compressed_bytes: int = 0

    def as_dict(self) -> Dict:
        return {
            "plane": self.plane,
            "raw_chunks": self.raw_chunks,
            "rle_chunks": self.rle_chunks,
            "huffman_chunks": self.huffman_chunks,
            "compressed_bytes": self.compressed_bytes,
        }


def frame_stats(frame) -> Dict:
    """Introspect one ``.znn`` frame: header fields + per-plane histograms.

    Works on any frame the byte-grouped path wrote (whole-buffer method
    frames report header info only).
    """
    from . import codec  # noqa: PLC0415

    hdr, consumed = Header.from_bytes(frame, formats_with_shape=(2, 3, 5))
    info = {
        "version": hdr.version,
        "method": hdr.method,
        "input_format": hdr.input_format,
        "dtype_code": hdr.dtype_code,
        "byte_reorder": hdr.byte_reorder,
        "bit_reorder": hdr.bit_reorder,
        "compression_chunk": hdr.compression_chunk,
        "is_streaming_frame": hdr.is_streaming,
        "original_len": hdr.original_len,
        "total_len": hdr.total_len,
        "ratio": hdr.total_len / hdr.original_len if hdr.original_len else 0.0,
        "shape": hdr.shape,
    }
    try:
        num_buf = dtypes.groups_for_decompress(hdr.dtype_code)
    except ValueError:
        return info  # whole-buffer / non-grouped frame

    chunk = codec.effective_chunk(hdr.compression_chunk, num_buf)
    n_chunks = codec.num_chunks_for(hdr.original_len, chunk)
    if n_chunks == 0:
        return info
    payload = memoryview(frame)[consumed : hdr.total_len or None]
    types, starts, _ = codec.parse_tables(payload, num_buf, n_chunks)
    sizes = starts[:, 1:] - starts[:, :-1]
    planes: List[Dict] = []
    for b in range(num_buf):
        ps = PlaneStats(plane=b)
        ps.raw_chunks = int(np.sum(types[b] == 0))
        ps.rle_chunks = int(np.sum((types[b] == 1) & (sizes[b] == 1)))
        ps.huffman_chunks = int(np.sum(types[b] == 1)) - ps.rle_chunks
        ps.compressed_bytes = int(sizes[b].sum())
        planes.append(ps.as_dict())
    info["planes"] = planes
    return info


@contextmanager
def trace(log_dir: str, label: str = "zipnn"):
    """Record a ``torch.profiler`` trace of a codec region, as one
    ``label`` span, and yield the profiler.

    Usage::

        with zipnn_tpu_torch.stats.trace("/tmp/znn-trace") as prof:
            znn.decompress(buf)
        print(prof.key_averages().table())

    Host activity is always recorded, the card's kernels and copies
    whenever CUDA is available.  On leaving, the trace is written under
    ``log_dir`` as a Chrome / TensorBoard JSON (``*.pt.trace.json``; view it
    in Perfetto or TensorBoard), also when the region raises; the
    exception goes on.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        with torch.profiler.record_function(label):
            yield prof


def file_stats(path_or_bytes) -> Dict:
    """Frame stats for a file path or a bytes-like object (all frames)."""
    if isinstance(path_or_bytes, str):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = path_or_bytes
    from .core.header import walk_frames  # noqa: PLC0415

    mv = memoryview(data)
    frames = []
    if len(mv) >= HEADER_LEN and mv[13] > 127:  # streaming container
        for offset, total in walk_frames(mv):
            frames.append(frame_stats(mv[offset : offset + total]))
    else:
        frames.append(frame_stats(mv))
    out = {
        "frames": frames,
        "original_len": sum(f["original_len"] for f in frames),
        "total_len": len(data),
    }
    out["ratio"] = out["total_len"] / out["original_len"] if out["original_len"] else 0.0
    return out


_cuda_up = False  # torch.cuda.is_initialized() of the process, kept once true: it never turns false


class phase:
    """Name one codec phase ``znn:<label>`` for a :func:`trace` capture
    (``torch.profiler.record_function``) and, once CUDA is initialised, for
    a CUDA tool (an NVTX range).

    The encoder and decoder wrap their host-visible phases in these, each
    exactly where its ``last_timings`` clock starts and stops, so a trace
    shows named spans around the kernels they queue; the staged decode
    names its per-container enqueue, output allocation and validation
    fetch.  Outside a capture only the profiler check and, once CUDA is
    up, the NVTX push and pop run (1.2-2.1 µs a pair on an H100's host);
    an exception inside goes on."""

    __slots__ = ("name", "span", "nvtx")

    def __init__(self, label: str):
        self.name = f"znn:{label}"

    def __enter__(self):
        global _cuda_up
        if not _cuda_up:
            _cuda_up = torch.cuda.is_initialized()
        self.nvtx = _cuda_up
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.span = None
        if torch.autograd._profiler_enabled():
            self.span = torch.profiler.record_function(self.name)
            self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            self.span.__exit__(*exc)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        return False
