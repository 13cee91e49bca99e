"""Batch-compress every file with a suffix under a path
(reference scripts/zipnn_compress_path.py).  ``--engine`` and ``--device``
go to every file's job; with ``--max_processes`` above 1 the jobs run in
worker processes started by ``spawn`` (a forked child cannot use CUDA once
its parent has)."""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, as_completed

from . import SUFFIX, add_engine_args, die, parse_streaming_chunk_size

INDEX_JSON = "model.safetensors.index.json"
WEIGHTS_INDEX_JSON = "pytorch_model.bin.index.json"


def resolve_hf_cache_path(model: str, branch: str = "main") -> str:
    """Resolve a model id to its hub-cache snapshot directory
    (reference zipnn_compress_path.py:117-142)."""
    from huggingface_hub import scan_cache_dir  # noqa: PLC0415

    cache = scan_cache_dir()
    repo = next(
        (r for r in cache.repos if r.repo_id == model and r.repo_type == "model"), None
    )
    if repo is None:
        die(f"Model {model} not found in the local HF cache")
    ref_path = os.path.join(repo.repo_path, "refs", branch)
    if not os.path.exists(ref_path):
        die(f"Branch {branch} not found for {model}")
    with open(ref_path) as f:
        commit = f.read().strip()
    return os.path.join(repo.repo_path, "snapshots", commit)


def find_files(path: str, suffix: str, recursive: bool):
    suffix = suffix if suffix.startswith(".") else "." + suffix
    out = []
    if recursive:
        for root, _dirs, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in files if f.endswith(suffix))
    else:
        out = [
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith(suffix) and os.path.isfile(os.path.join(path, f))
        ]
    return sorted(f for f in out if not f.endswith(SUFFIX))


def rewrite_index_json(path: str, add_suffix: bool) -> None:
    """Point the sharded-checkpoint index at the (de)compressed file names
    (reference zipnn_compress_path.py:207-237)."""
    for name in (INDEX_JSON, WEIGHTS_INDEX_JSON):
        idx = os.path.join(path, name)
        if not os.path.exists(idx):
            continue
        target = os.path.join(path, os.readlink(idx)) if os.path.islink(idx) else idx
        with open(target) as f:
            data = json.load(f)
        wm = data.get("weight_map", {})
        for k, v in wm.items():
            if add_suffix and not v.endswith(SUFFIX):
                wm[k] = v + SUFFIX
            elif not add_suffix and v.endswith(SUFFIX):
                wm[k] = v[: -len(SUFFIX)]
        with open(target, "w") as f:
            json.dump(data, f, indent=2)


def _one(args):
    path, kwargs, per_tensor = args
    try:
        if per_tensor:
            from .compress_safetensors import compress_safetensors_file  # noqa: PLC0415

            return compress_safetensors_file(
                path,
                delete=kwargs.get("delete", False),
                force=True,
                hf_cache=kwargs.get("hf_cache", False),
                threads=kwargs.get("threads"),
                device=kwargs.get("device", "cuda"),
            )
        from .compress_file import compress_file  # noqa: PLC0415

        return compress_file(path, force=True, **kwargs)
    except Exception as exc:  # keep the batch going (reference :277-282)
        return f"ERROR {path}: {exc}"


def run_jobs(fn, jobs, max_processes: int) -> None:
    """``fn`` over ``jobs`` in this process, or in up to ``max_processes``
    spawned workers; prints each ``ERROR`` line a job returns."""
    if max_processes <= 1 or len(jobs) == 1:
        results = map(fn, jobs)
    else:
        ex = ProcessPoolExecutor(max_workers=max_processes,
                                 mp_context=multiprocessing.get_context("spawn"))
        with ex:
            results = [f.result() for f in as_completed([ex.submit(fn, j) for j in jobs])]
    for r in results:
        if isinstance(r, str) and r.startswith("ERROR"):
            print(r)


def compress_files_with_suffix(
    suffix: str,
    path: str = ".",
    dtype: str = "bfloat16",
    streaming_chunk_size=None,
    delete: bool = False,
    recursive: bool = False,
    force: bool = False,
    max_processes: int = 1,
    hf_cache: bool = False,
    model: str = None,
    model_branch: str = "main",
    method: str = "HUFFMAN",
    verification: bool = False,
    test: bool = False,
    is_streaming: bool = True,
    threads=None,
    per_tensor: bool = False,
    engine: str = "cuda",
    device="cuda",
) -> None:
    if model:
        path = resolve_hf_cache_path(model, model_branch)
        hf_cache = True
    files = find_files(path, suffix, recursive)
    if not files:
        print(f"No *.{suffix.lstrip('.')} files under {path}")
        return
    if not force:
        print(f"About to compress {len(files)} files under {path}:")
        for f in files[:20]:
            print(" ", f)
        if input("Proceed (y/n)? ").strip().lower() not in ("y", "yes"):
            return

    kwargs = dict(
        dtype=dtype,
        streaming_chunk_size=parse_streaming_chunk_size(streaming_chunk_size),
        delete=delete,
        hf_cache=hf_cache,
        method=method,
        verification=verification,
        test=test,
        is_streaming=is_streaming,
        threads=threads,
        engine=engine,
        device=device,
    )
    run_jobs(_one, [(f, kwargs, per_tensor) for f in files], max_processes)
    if suffix.lstrip(".") == "safetensors" and not test and not per_tensor:
        rewrite_index_json(path, add_suffix=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Compress all files with a suffix.")
    p.add_argument("suffix", type=str, help="file suffix to compress (e.g. safetensors)")
    p.add_argument("--path", type=str, default=".")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--streaming_chunk_size", type=str, default=None)
    p.add_argument("--delete", action="store_true")
    p.add_argument("-r", "--recursive", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--max_processes", type=int, default=1)
    p.add_argument("--hf_cache", action="store_true")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--model_branch", type=str, default="main")
    p.add_argument("--method", type=str, default="HUFFMAN")
    p.add_argument("--verification", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--is_streaming", action="store_true", default=True)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--per_tensor", action="store_true",
                   help="per-tensor safetensors codec instead of whole-file")
    add_engine_args(p)
    a = p.parse_args(argv)
    compress_files_with_suffix(
        a.suffix, path=a.path, dtype=a.dtype,
        streaming_chunk_size=a.streaming_chunk_size, delete=a.delete,
        recursive=a.recursive, force=a.force, max_processes=a.max_processes,
        hf_cache=a.hf_cache, model=a.model, model_branch=a.model_branch,
        method=a.method, verification=a.verification, test=a.test,
        is_streaming=a.is_streaming, threads=a.threads, per_tensor=a.per_tensor,
        engine=a.engine, device=a.device,
    )


if __name__ == "__main__":
    main()
