"""Command-line tools of the PyTorch/CUDA port (the JAX package's
``zipnn_tpu/cli``, with the same scripts, flags and files).

Run as modules::

    python -m zipnn_tpu_torch.cli.compress_file model.safetensors
    python -m zipnn_tpu_torch.cli.decompress_file model.safetensors.znn
    python -m zipnn_tpu_torch.cli.compress_path safetensors --path ckpts/ -r
    python -m zipnn_tpu_torch.cli.decompress_path --path ckpts/
    python -m zipnn_tpu_torch.cli.compress_safetensors model.safetensors
    python -m zipnn_tpu_torch.cli.decompress_safetensors model.znn.safetensors
    python -m zipnn_tpu_torch.cli.compress_file_delta ckpt.bin base.bin
    python -m zipnn_tpu_torch.cli.decompress_file_delta ckpt.bin.znn base.bin

``--engine`` takes ``auto|numpy|native|cuda`` and defaults to ``cuda``, on
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
The path scripts start their worker processes by ``spawn``: a forked
child cannot use CUDA once its parent has.
"""
from __future__ import annotations

import os
import sys
import time

from .. import codec

KB, MB, GB = 1024, 1024**2, 1024**3
SUFFIX = ".znn"


def parse_streaming_chunk_size(value) -> int:
    """'int' bytes or 'int{KB,MB,GB}' (reference zipnn_compress_file.py:38-56)."""
    if value is None:
        return MB
    if isinstance(value, int):
        return value
    s = str(value).strip().upper()
    for unit, mult in (("KB", KB), ("MB", MB), ("GB", GB)):
        if s.endswith(unit):
            return int(s[: -len(unit)]) * mult
    return int(s)


def confirm_overwrite(path: str, force: bool) -> bool:
    if force or not os.path.exists(path):
        return True
    ans = input(f"{path} exists; overwrite (y/n)? ").strip().lower()
    return ans in ("y", "yes")


def hf_cache_replace(original: str, produced: str) -> None:
    """Hub-cache symlink surgery: point a new snapshot symlink at a blob
    (reference zipnn_compress_file.py:153-164)."""
    if not os.path.islink(original):
        return
    blob = os.path.join(os.path.dirname(original), os.readlink(original))
    new_blob = blob + (SUFFIX if produced.endswith(SUFFIX) else "")
    if os.path.abspath(produced) != os.path.abspath(new_blob):
        os.rename(produced, new_blob)
        os.symlink(new_blob, produced)


def throughput(nbytes: int, seconds: float) -> str:
    if seconds <= 0:
        return "inf"
    return f"{nbytes / seconds / GB:.2f} GB/s"


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False


def die(msg: str, code: int = 1):
    print(msg, file=sys.stderr)
    raise SystemExit(code)


def add_engine_args(p) -> None:
    """``--engine`` (default ``cuda``) and ``--device`` (default ``cuda``)."""
    p.add_argument("--engine", choices=codec.ENGINES, default="cuda",
                   help="codec engine (default cuda: the card's kernels)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of engine cuda (default cuda; cpu runs the plain versions)")
