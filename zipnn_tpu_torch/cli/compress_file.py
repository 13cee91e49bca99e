"""Compress one file to ``<file>.znn`` (reference scripts/zipnn_compress_file.py)."""
from __future__ import annotations

import argparse
import os

from ..zipnn import ZipNN
from . import (SUFFIX, Timer, add_engine_args, confirm_overwrite, die, hf_cache_replace,
               parse_streaming_chunk_size, throughput)

DTYPES = ["bfloat16", "float16", "float32", "float8_e4m3fn", "float8_e5m2"]

# the last call's seconds: reading the file (read_s), the compress
# (compress_s, the one the printed GB/s is of) and writing the .znn (write_s)
last_timings: dict = {}


def compress_file(
    input_file: str,
    dtype: str = "bfloat16",
    streaming_chunk_size=None,
    delete: bool = False,
    force: bool = False,
    hf_cache: bool = False,
    method: str = "HUFFMAN",
    verification: bool = False,
    test: bool = False,
    is_streaming: bool = True,
    threads=None,
    engine: str = "cuda",
    huffman_table: str = "per_chunk",
    compression_chunk: int = 256 * 1024,
    device="cuda",
) -> str | None:
    if not os.path.isfile(input_file):
        die(f"No such file: {input_file}")
    if input_file.endswith(SUFFIX):
        die(f"{input_file} is already compressed")
    output_file = input_file + SUFFIX

    if delete:
        os.remove(input_file)
        print(f"Deleted {input_file}")
        return None
    if not test and not confirm_overwrite(output_file, force):
        print("Skipping.")
        return None

    znn = ZipNN(
        method=method,
        input_format="byte",
        bytearray_dtype=dtype,
        is_streaming=is_streaming,
        streaming_chunk=parse_streaming_chunk_size(streaming_chunk_size),
        threads=threads or 0,
        engine=engine,
        huffman_table=huffman_table,
        compression_chunk=compression_chunk,
        device=device,
    )
    last_timings.clear()
    with Timer() as tr, open(input_file, "rb") as f:
        data = f.read()
    with Timer() as t:
        comp = znn.compress(data)
    last_timings.update(read_s=tr.seconds, compress_s=t.seconds)
    ratio = len(comp) / max(len(data), 1)
    print(
        f"Compressed {input_file}: {len(data)} -> {len(comp)} bytes "
        f"(ratio {ratio:.4f}, saved {100 * (1 - ratio):.1f}%), "
        f"{throughput(len(data), t.seconds)}"
    )

    if verification:
        ver = ZipNN(
            method=method, input_format="byte", bytearray_dtype=dtype,
            is_streaming=is_streaming, threads=threads or 0, engine=engine, device=device,
        )
        with Timer() as td:
            back = ver.decompress(comp)
        if bytes(back) != data:
            die("Verification FAILED: decompressed bytes differ")
        print(f"Verification OK ({throughput(len(data), td.seconds)})")

    if test:
        return None
    with Timer() as tw, open(output_file, "wb") as f:
        f.write(comp)
    last_timings["write_s"] = tw.seconds
    if hf_cache:
        hf_cache_replace(input_file, output_file)
    return output_file


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Compress a file to .znn.")
    p.add_argument("input_file", type=str, help="Path of the file to compress.")
    p.add_argument("--dtype", choices=DTYPES, default="bfloat16")
    p.add_argument("--streaming_chunk_size", type=str, default=None,
                   help="int bytes or int+KB/MB/GB (default 1MB)")
    p.add_argument("--delete", action="store_true", help="delete the file instead of compressing")
    p.add_argument("--force", action="store_true", help="overwrite without asking")
    p.add_argument("--hf_cache", action="store_true", help="file lives in the HF hub cache")
    p.add_argument("--method", choices=["HUFFMAN", "ZSTD", "AUTO", "LZ4", "SNAPPY"],
                   default="HUFFMAN")
    p.add_argument("--verification", action="store_true", help="roundtrip-verify after compressing")
    p.add_argument("--test", action="store_true", help="dry run, write nothing")
    p.add_argument("--is_streaming", action="store_true", default=True)
    p.add_argument("--threads", type=int, default=None)
    add_engine_args(p)
    p.add_argument("--huffman_table", choices=["per_chunk", "shared"], default="per_chunk",
                   help="'shared' = one <=8-bit table per byte plane")
    p.add_argument("--compression_chunk", type=int, default=256 * 1024)
    a = p.parse_args(argv)
    compress_file(
        a.input_file, dtype=a.dtype, streaming_chunk_size=a.streaming_chunk_size,
        delete=a.delete, force=a.force, hf_cache=a.hf_cache, method=a.method,
        verification=a.verification, test=a.test, is_streaming=a.is_streaming,
        threads=a.threads, engine=a.engine, huffman_table=a.huffman_table,
        compression_chunk=a.compression_chunk, device=a.device,
    )


if __name__ == "__main__":
    main()
