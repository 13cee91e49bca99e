"""Batch-decompress ``.znn`` files under a path
(reference scripts/zipnn_decompress_path.py).  ``--engine`` and
``--device`` go to every file's job (a ``.znn.safetensors`` file takes the
device only); worker processes start by ``spawn``."""
from __future__ import annotations

import argparse
import os

from . import SUFFIX, add_engine_args
from .compress_path import resolve_hf_cache_path, rewrite_index_json, run_jobs


def _one(args):
    path, kwargs = args
    kwargs = dict(kwargs)
    retries = kwargs.pop("retries", 1)
    last = None
    for attempt in range(retries + 1):
        try:
            if path.endswith(".znn.safetensors"):
                from .decompress_safetensors import decompress_safetensors_file  # noqa: PLC0415

                kwargs.pop("engine", None)
                return decompress_safetensors_file(path, force=True, **kwargs)
            from .decompress_file import decompress_file  # noqa: PLC0415

            return decompress_file(path, force=True, **kwargs)
        except Exception as exc:
            last = exc
            # CorruptChunkError carries (plane, chunk, stream) — a
            # deterministic decode failure: retrying would just decode the
            # same corrupt bytes again.  Retries cover transient IO faults.
            from ..errors import CorruptChunkError  # noqa: PLC0415

            if isinstance(exc, CorruptChunkError):
                break
            if attempt < retries:
                continue
    return f"ERROR {path}: {type(last).__name__}: {last}"


def decompress_znn_files(
    path: str = ".",
    delete: bool = False,
    recursive: bool = False,
    force: bool = False,
    max_processes: int = 1,
    hf_cache: bool = False,
    model: str = None,
    model_branch: str = "main",
    threads=None,
    retries: int = 1,
    engine: str = "cuda",
    device="cuda",
) -> None:
    if model:
        path = resolve_hf_cache_path(model, model_branch)
        hf_cache = True
    files = []
    if recursive:
        for root, _dirs, fs in os.walk(path):
            files.extend(os.path.join(root, f) for f in fs)
    else:
        files = [os.path.join(path, f) for f in os.listdir(path)]
    files = sorted(
        f for f in files
        if os.path.isfile(f) and (f.endswith(SUFFIX) or f.endswith(".znn.safetensors"))
    )
    if not files:
        print(f"No .znn files under {path}")
        return
    if not force:
        print(f"About to decompress {len(files)} files under {path}:")
        for f in files[:20]:
            print(" ", f)
        if input("Proceed (y/n)? ").strip().lower() not in ("y", "yes"):
            return
    kwargs = dict(delete=delete, hf_cache=hf_cache, threads=threads, retries=retries,
                  engine=engine, device=device)
    run_jobs(_one, [(f, kwargs) for f in files], max_processes)
    rewrite_index_json(path, add_suffix=False)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Decompress .znn files under a path.")
    p.add_argument("--path", type=str, default=".")
    p.add_argument("--delete", action="store_true")
    p.add_argument("-r", "--recursive", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--max_processes", type=int, default=1)
    p.add_argument("--hf_cache", action="store_true")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--model_branch", type=str, default="main")
    p.add_argument("--threads", type=int, default=None)
    p.add_argument(
        "--retries", type=int, default=1,
        help="re-attempts per file before reporting it failed (default 1)",
    )
    add_engine_args(p)
    a = p.parse_args(argv)
    decompress_znn_files(
        path=a.path, delete=a.delete, recursive=a.recursive, force=a.force,
        max_processes=a.max_processes, hf_cache=a.hf_cache, model=a.model,
        model_branch=a.model_branch, threads=a.threads, retries=a.retries,
        engine=a.engine, device=a.device,
    )


if __name__ == "__main__":
    main()
