"""ctypes binding of the port's native C++ host core (``csrc/ztpu_core.cpp``).

The library is the port's own copy of the JAX package's host codec, so
engine ``"native"`` writes the reference engine's containers, plus the
entries the card's encode and decode paths call for their host steps:

* :func:`build_ctables`: every surviving cell's Huffman table of one
  per-chunk encode batch in one call;
* :func:`huf_compress`: the per-chunk profile's tail cell;
* :func:`splice_cells`: every cell of a batch into the container buffer;
* :func:`cell_tables`: the decode tables of a container's weight headers.

It is compiled at first use, never at import, with ``g++`` and the
reference's flags, into ``zipnn_tpu_torch/_build/`` (listed in
``.gitignore``) under a name hashed from the source, the flags and the
host CPU's flags line (the build is ``-march=native``, so a copied
``_build/`` never serves a library built for another CPU).  The compile
writes a temporary file under a file lock and renames it into place, so
concurrent processes build once and never load a half-written file.  A
failed build raises :class:`NativeBuildError`.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SRC = PKG_DIR / "csrc" / "ztpu_core.cpp"
BUILD_DIR = PKG_DIR / "_build"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall")
HDR_STRIDE = 128  # bytes per weight header of build_ctables (FSE headers <= 128)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None  # of this process's compile, None if it loaded a built one

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_S = ctypes.c_size_t
_I = ctypes.c_int
_U = ctypes.c_uint
_D = ctypes.c_double
_SIGNATURES = {
    # data, n, num_buf, bit_reorder, byte_reorder, chunk, threshold, threads,
    # check_th_after_percent, raw_planes_mask, out, out_cap
    "ztpu_compress": [_P, _S, _U, _I, _I, _S, _D, _I, _I, _U, _P, _S],
    # ... threads, preset_lengths, preset_live, out, out_cap
    "ztpu_compress_shared": [_P, _S, _U, _I, _I, _S, _D, _I, _P, _P, _P, _S],
    # payload, len, num_buf, bit_reorder, byte_reorder, chunk, orig, threads, out
    "ztpu_decompress": [_P, _S, _U, _I, _I, _S, _S, _I, _P],
    "ztpu_huf_compress": [_P, _S, _P, _S],
    # payload, offsets, sizes, n, weights out, tlogs out, threads
    "ztpu_parse_dweights": [_P, _P, _P, _L, _P, _P, _I],
    # weights, tlogs, n, tlog_k, out, threads
    "ztpu_expand_dtables16": [_P, _P, _L, _I, _P, _I],
    # counts, m, n, status, lengths, vals, headers, hdr_stride, hlens, threads
    "ztpu_build_ctables": [_P, _L, _L, _P, _P, _P, _P, _L, _P, _I],
    # out, n_cells, starts, kinds, sizes, rle_vals, hids, hpool, pool_len, hoffs,
    # hlens, n_headers, jumps, boffs, blob, blob_len, threads
    "ztpu_splice_cells": [_P, _L, _P, _P, _P, _P, _P, _P, _L, _P, _P, _L, _P, _P, _P, _L, _I],
    "ztpu_sample_policy": [_P, _P],
}


class NativeBuildError(RuntimeError):
    """``g++`` could not build the native core."""


class SharedOverflow(RuntimeError):
    """A plane histogram of the shared profile exceeded uint32 (more than
    ~8.5 GB in one call)."""


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.strip()
    except OSError:
        pass
    return ""


def source_tag() -> str:
    """Digest of the source, the flags and the host CPU's flags line: the
    built library's name."""
    digest = hashlib.sha1(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(_cpu_flags().encode())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile the library (if no process has yet for this source, these
    flags and this CPU); returns the .so."""
    global build_seconds
    so = BUILD_DIR / f"libztpu_core_{source_tag()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "ztpu_core.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compile; the others wait, then load it
        if so.exists():
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                             capture_output=True, text=True)
        if res.returncode:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"g++ failed on {SRC.name}:\n{res.stderr}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = None if name == "ztpu_sample_policy" else ctypes.c_longlong
            _check_policy(handle)
            _lib = handle
    return _lib


def _check_policy(handle) -> None:
    """The shared profile's sampling policy is part of the format: a
    constant that drifted between the core and ``codec`` would break
    byte identity across engines, so it fails loudly."""
    from . import codec  # noqa: PLC0415

    mc, st = ctypes.c_uint(), ctypes.c_uint()
    handle.ztpu_sample_policy(ctypes.byref(mc), ctypes.byref(st))
    if (mc.value, st.value) != (codec.SHARED_SAMPLE_MIN_CHUNKS, codec.SHARED_SAMPLE_STRIDE):
        raise RuntimeError(
            f"native sampling policy ({mc.value}, {st.value}) != codec policy "
            f"({codec.SHARED_SAMPLE_MIN_CHUNKS}, {codec.SHARED_SAMPLE_STRIDE})")


@functools.lru_cache(maxsize=1)
def _threads() -> int:
    """The host's core count, read once (each read is a system call)."""
    return os.cpu_count() or 1


def _c(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


# ---------------------------------------------------------------------------
# engine "native": the whole host codec
# ---------------------------------------------------------------------------

def _out_buffer(n: int, n_chunks: int, num_buf: int):
    cap = n + n_chunks * num_buf * 9 + 4096 + (n_chunks + 1) * 64
    return np.empty(cap, dtype=np.uint8)


def compress_payload(data, num_buf: int, bit_reorder: int, byte_reorder: int,
                     chunk_size: int, threshold: float,
                     check_th_after_percent: int = 0) -> np.ndarray:
    """The per-chunk profile's payload, byte-equal to the golden encoder's:
    a uint8 view of the core's worst-case output buffer (about the input's
    size)."""
    data = _c(data, np.uint8).reshape(-1)
    out = _out_buffer(data.size, -(-data.size // chunk_size), num_buf)
    r = lib().ztpu_compress(data.ctypes.data, data.size, num_buf, bit_reorder, byte_reorder,
                            chunk_size, threshold, _threads(),
                            int(check_th_after_percent or 0), 0,
                            out.ctypes.data, out.size)
    if r < 0:
        raise RuntimeError(f"native compress failed: {r}")
    return out[:r]


def compress_payload_shared(data, num_buf: int, bit_reorder: int, byte_reorder: int,
                            chunk_size: int, threshold: float) -> np.ndarray:
    """The shared-table profile's payload, as :func:`compress_payload`
    gives the per-chunk one.  Raises :class:`SharedOverflow` past the
    core's uint32 histograms."""
    data = _c(data, np.uint8).reshape(-1)
    out = _out_buffer(data.size, -(-data.size // chunk_size), num_buf)
    r = lib().ztpu_compress_shared(data.ctypes.data, data.size, num_buf, bit_reorder,
                                   byte_reorder, chunk_size, threshold, _threads(),
                                   None, None, out.ctypes.data, out.size)
    if r == -2:
        raise SharedOverflow("a shared-profile plane histogram exceeds uint32")
    if r < 0:
        raise RuntimeError(f"native shared compress failed: {r}")
    return out[:r]


def decompress_payload(payload, num_buf: int, bit_reorder: int, byte_reorder: int,
                       chunk_size: int, orig_size: int) -> np.ndarray:
    """Decode a payload of either profile into a host uint8 array; raises
    RuntimeError on a corrupt one."""
    buf = _c(np.frombuffer(memoryview(payload), dtype=np.uint8), np.uint8)
    out = np.empty(orig_size, dtype=np.uint8)
    r = lib().ztpu_decompress(buf.ctypes.data, buf.size, num_buf, bit_reorder, byte_reorder,
                              chunk_size, orig_size, _threads(), out.ctypes.data)
    if r != 0:
        raise RuntimeError(f"native decompress failed: {r}")
    return out


# ---------------------------------------------------------------------------
# the host steps of the card's encode and decode
# ---------------------------------------------------------------------------

def huf_compress(block: np.ndarray) -> Optional[bytes]:
    """One block by the golden ``huf.compress`` rules: its own table, the
    1-byte RLE block, or None (store raw)."""
    block = _c(block, np.uint8).reshape(-1)
    cap = block.size + 4096
    out = np.empty(cap, dtype=np.uint8)
    r = lib().ztpu_huf_compress(block.ctypes.data, block.size, out.ctypes.data, cap)
    if r < 0:
        raise RuntimeError("native huf compress failed")
    return None if r == 0 else out[:r].tobytes()


def build_ctables(counts: np.ndarray, n: int):
    """Huffman tables of ``m`` cells of ``n`` bytes from their byte counts
    ([m, 256]), one call: (status uint8 [m] (1 Huffman, 0 raw), lengths
    uint8 [m, 256], canonical values uint16 [m, 256], headers uint8
    [m, HDR_STRIDE], header lengths int32 [m]).  Equal, row by row, to
    ``ops.encode.cell_table``."""
    counts = _c(counts, np.uint32).reshape(-1, 256)
    m = counts.shape[0]
    status = np.empty(m, dtype=np.uint8)
    lengths = np.empty((m, 256), dtype=np.uint8)
    vals = np.empty((m, 256), dtype=np.uint16)
    headers = np.zeros((m, HDR_STRIDE), dtype=np.uint8)
    hlens = np.empty(m, dtype=np.int32)
    r = lib().ztpu_build_ctables(counts.ctypes.data, m, n, status.ctypes.data,
                                 lengths.ctypes.data, vals.ctypes.data, headers.ctypes.data,
                                 HDR_STRIDE, hlens.ctypes.data, _threads())
    if r != 0:
        raise ValueError(f"build_ctables: bad arguments (n={n})")
    return status, lengths, vals, headers, hlens


HEADERS_PER_THREAD = 256


def cell_tables(pool: np.ndarray, offsets: np.ndarray, sizes: np.ndarray):
    """Decode tables of weight headers (header ``i`` at ``pool[offsets[i]]``,
    at most ``sizes[i]`` bytes): (tables int16 [n, 2^tlog_k], entries
    ``symbol | nb << 8`` of ``huf.build_dtable``, zero past each cell's
    ``2^tlog``; tlogs int32 [n]; tlog_k).  A corrupt header raises
    ValueError with ``.index``, the first bad cell."""
    L = lib()
    pool = _c(pool, np.uint8)
    off = _c(offsets, np.int64)
    szs = _c(sizes, np.int64)
    n = off.size
    # a header parses in microseconds, and each call starts its threads
    # afresh: a thread only for every HEADERS_PER_THREAD headers
    threads = min(_threads(), 1 + n // HEADERS_PER_THREAD)
    weights = np.empty((n, 256), dtype=np.uint8)
    tlogs = np.empty(n, dtype=np.int32)
    args = (pool.ctypes.data, off.ctypes.data, szs.ctypes.data, n, weights.ctypes.data,
            tlogs.ctypes.data)
    r = L.ztpu_parse_dweights(*args, threads)
    if r != 0:
        r = L.ztpu_parse_dweights(*args, 1)  # in order: the first bad cell
        exc = ValueError(f"corrupt HUF weight header (cell {-r - 1})")
        exc.index = int(-r - 1)
        raise exc
    tlog_k = int(tlogs.max()) if n else 1
    tables = np.empty((n, 1 << tlog_k), dtype=np.int16)
    if n and L.ztpu_expand_dtables16(weights.ctypes.data, tlogs.ctypes.data, n, tlog_k,
                                     tables.ctypes.data, threads):
        raise ValueError("expand_dtables16: tableLog out of range")
    return tables, tlogs, tlog_k


def splice_cells(out: np.ndarray, starts, kinds, sizes, rle_vals, hids, hpool, hoffs,
                 hlens, jumps, boffs, blob) -> None:
    """Write cells into ``out`` (uint8) at absolute ``starts`` (see
    ``ztpu_splice_cells``): kind 0 copies ``sizes`` bytes of ``blob`` from
    ``boffs``; 1 writes ``rle_vals``; 2 writes pool header ``hids``, the
    jump table ``jumps`` [n, 3] and the stream bytes from ``boffs``."""
    starts = _c(starts, np.int64)
    n = starts.size
    kinds, sizes, rle_vals = _c(kinds, np.uint8), _c(sizes, np.int64), _c(rle_vals, np.uint8)
    hids, boffs = _c(hids, np.int64), _c(boffs, np.int64)
    hpool, hoffs, hlens = _c(hpool, np.uint8), _c(hoffs, np.int64), _c(hlens, np.int64)
    jumps, blob = _c(jumps, np.uint16), _c(blob, np.uint8)
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise TypeError("splice_cells: out must be a contiguous uint8 array")
    if n and int((starts + sizes).max()) > out.size:
        raise ValueError("splice_cells: a cell ends past the output")
    r = lib().ztpu_splice_cells(
        out.ctypes.data, n, starts.ctypes.data, kinds.ctypes.data, sizes.ctypes.data,
        rle_vals.ctypes.data, hids.ctypes.data, hpool.ctypes.data, hpool.size,
        hoffs.ctypes.data, hlens.ctypes.data, hoffs.size, jumps.ctypes.data, boffs.ctypes.data,
        blob.ctypes.data, blob.size, _threads())
    if r != 0:
        raise ValueError(f"splice_cells: cell {-r - 1} reads outside its blob or header pool")
