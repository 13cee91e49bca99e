"""Build and load the port's CUDA kernels; count their launches.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, never at import, into ``zipnn_tpu_torch/_build/`` (listed in
``.gitignore``), under a name derived from the content of the sources and
of the headers they include (``csrc/*.cuh``), so an edited file is never
served a stale library.

``launches`` counts kernel launches by wrapper name: a wrapper adds one
where it launches its kernel and nowhere else.  ``combined_bytes`` counts,
beside it, the plane bytes that K2 (``combine_cells``, or its plain
version on the CPU) assembled, by the kind of cell they came from:
``ops/decode.py`` adds each batch's totals as it launches the batch.
``launch_sets`` counts the launch sets of ``ops/decode.py`` and the
containers they decoded.  ``reset_launches`` zeroes all three.  Inside ``with
recording() as events``, each launch that the calling thread makes appends
``(name, start, end)`` to ``events``: CUDA events recorded on the launch's
stream right before and right after the kernel, so their interval holds
the kernel and none of the host work around it (``elapsed_ms`` sums them).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

launches: Dict[str, int] = {
    "huf_pc_decode": 0, "huf_shared_decode": 0, "combine_cells": 0,
    "combine_cells_grouped": 0, "huf_shared_encode": 0, "const_scan_rows": 0,
    "hist_cells": 0, "huf_pc_encode": 0, "splice_cells": 0,
}

# bytes K2 copied from stored cells, filled from RLE cells and took from
# Huffman cells' symbol rows, keyed in the order of ``ops/decode.py``'s cell
# kinds 0, 1, 2 (not in ``launches``: that one sums to a count)
combined_bytes: Dict[str, int] = {"stored": 0, "rle": 0, "huffman": 0}

# launch sets started (``ops/decode.py`` ``LaunchSet``: one K1 launch per
# schedule and one K2 launch for pieces of many containers) and the
# containers they covered, each once a set (not in ``launches`` either)
launch_sets: Dict[str, int] = {"sets": 0, "containers": 0}

# the event list of the innermost ``recording()`` block of this thread
_recording: contextvars.ContextVar = contextvars.ContextVar("recording", default=None)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # payload, starts, lens, bits0, out_offs, out_lens, cells, tlogs,
    # tables, table_stride, n_streams, lanes, min_seg_bits, group, out,
    # bits_left, passes, stream
    "huf_pc_decode": [_P] * 9 + [_L, _I, _I, _I, _I, _P, _P, _P, _P],
    # payload, starts, lens, bits0, out_offs, out_lens, table, n_streams,
    # lanes, min_seg_bits, group, out, bits_left, passes, stream
    "huf_shared_decode": [_P] * 7 + [_I, _I, _I, _I, _P, _P, _P, _P],
    # payload, hsym, kinds, srcs, hsym_row, chunk_size, total_bytes,
    # num_buf, byte_reorder, bit_reorder, out, stream
    "combine_cells": [_P] * 4 + [_L, _L, _L, _I, _I, _I, _P, _P],
    # payload, hsym, kinds, srcs, chunk_offs, chunk_lens, n_chunks,
    # chunk_size, hsym_row, num_buf, byte_reorder, bit_reorder, out, stream
    "combine_cells_grouped": [_P] * 6 + [_L, _L, _L, _I, _I, _I, _P, _P],
    # planes, streams, table, n_streams, seg_words, row_words, group, rows,
    # total_bits, stream
    "huf_shared_encode": [_P] * 3 + [_I, _I, _I, _I, _P, _P, _P],
    # planes, streams, tables, n_streams, seg_words, row_words, group, parts,
    # rows, total_bits, stream
    "huf_pc_encode": [_P] * 3 + [_I, _I, _I, _I, _I, _P, _P, _P],
    # rows, n_rows, width, out, stream
    "const_scan_rows": [_P, _L, _L, _P, _P],
    # rows, n_rows, width, out, stream
    "hist_cells": [_P, _L, _L, _P, _P],
    # out, desc, n_groups, n_cells, hpool, stream
    "splice_cells": [_P, _P, _I, _L, _P, _P],
}


def reset_launches() -> None:
    for counter in (launches, combined_bytes, launch_sets):
        for k in counter:
            counter[k] = 0


@contextlib.contextmanager
def recording():
    """Yield a list that collects ``(name, start, end)`` CUDA events for
    every launch this thread makes inside the block."""
    events: List = []
    token = _recording.set(events)
    try:
        yield events
    finally:
        _recording.reset(token)


def elapsed_ms(events, names=()) -> Dict[str, float]:
    """Device milliseconds by kernel name of ``recording()`` events (every
    name in ``names`` present, 0 if it never ran); synchronises on them."""
    ms = dict.fromkeys(names, 0.0)
    for name, start, end in events:
        end.synchronize()
        ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
    return ms


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_tag() -> str:
    """A digest of every kernel source and header (``csrc/*.cu``,
    ``csrc/*.cuh``): the built library's name."""
    digest = hashlib.sha1()
    for s in sorted(_sources() + list(CSRC.glob("*.cuh"))):
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels (if not built yet); returns the .so."""
    srcs = _sources()
    tag = source_tag()
    so = BUILD_DIR / f"libzipnn_cuda_{tag}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
    procs = []
    objs = []
    for s in srcs:
        o = obj_dir / (s.stem + ".o")
        objs.append(o)
        procs.append(
            (s, subprocess.Popen(
                [nvcc, *flags, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        )
    logs = []
    failed = []
    for s, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {s.name}\n{out}")
        if p.returncode:
            failed.append(s.name)
    (obj_dir / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = obj_dir / so.name
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent build never loads a torn file
    return so


def build_log() -> str:
    """ptxas register/shared-memory report of the last build, if any."""
    logs = sorted(BUILD_DIR.glob("obj_*/build.log"), key=os.path.getmtime)
    return logs[-1].read_text() if logs else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, device, *args) -> None:
    """Call one C entry point on ``device``'s current CUDA stream; raise on
    a refused launch; count it."""
    import torch  # noqa: PLC0415

    fn = getattr(lib(), name)
    events = _recording.get()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if events is None:
            err = fn(*args, stream.cuda_stream)
        else:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(stream)
            err = fn(*args, stream.cuda_stream)
            end.record(stream)
            events.append((name, start, end))
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1
