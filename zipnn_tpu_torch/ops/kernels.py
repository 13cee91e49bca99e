"""Build and load the port's CUDA kernels; count their launches.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, never at import, into ``zipnn_tpu_torch/_build/`` (listed in
``.gitignore``), under a name derived from the sources' content so an
edited source is never served a stale library.

``launches`` counts kernel launches by wrapper name: a wrapper adds one
where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

launches: Dict[str, int] = {"huf_pc_decode": 0, "combine_cells": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # payload, starts, lens, bits0, out_offs, out_lens, cells, tlogs,
    # tables, table_stride, n_streams, out, bits_left, stream
    "huf_pc_decode": [_P] * 9 + [_L, _I, _P, _P, _P],
    # payload, hsym, kinds, srcs, hsym_row, chunk_size, total_bytes,
    # num_buf, byte_reorder, bit_reorder, out, stream
    "combine_cells": [_P] * 4 + [_L, _L, _L, _I, _I, _I, _P, _P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


def build() -> Path:
    """Compile and link the kernels (if not built yet); returns the .so."""
    srcs = _sources()
    digest = hashlib.sha1()
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    tag = digest.hexdigest()[:16]
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
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1
