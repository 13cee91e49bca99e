"""Delta-compress a file against a same-length base file
(reference scripts/zipnn_compress_file_delta.py)."""
from __future__ import annotations

import argparse
import os

from ..zipnn import ZipNN
from . import (SUFFIX, Timer, add_engine_args, confirm_overwrite, die,
               parse_streaming_chunk_size, throughput)


def compress_file_delta(
    input_file: str,
    delta_file: str,
    dtype: str = "bfloat16",
    streaming_chunk_size=None,
    delete: bool = False,
    force: bool = False,
    method: str = "HUFFMAN",
    verification: bool = False,
    test: bool = False,
    threads=None,
    engine: str = "cuda",
    device="cuda",
) -> str | None:
    for f in (input_file, delta_file):
        if not os.path.isfile(f):
            die(f"No such file: {f}")
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
        is_streaming=True,
        streaming_chunk=parse_streaming_chunk_size(streaming_chunk_size),
        delta_compressed_type="file",
        threads=threads or 0,
        engine=engine,
        device=device,
    )
    with open(input_file, "rb") as f:
        data = f.read()
    with Timer() as t:
        comp = znn.compress(data, delta_second_data=delta_file)
    ratio = len(comp) / max(len(data), 1)
    print(
        f"Delta-compressed {input_file} vs {delta_file}: "
        f"{len(data)} -> {len(comp)} bytes (ratio {ratio:.4f}), "
        f"{throughput(len(data), t.seconds)}"
    )
    if verification:
        ver = ZipNN(
            method=method, input_format="byte", bytearray_dtype=dtype,
            is_streaming=True, delta_compressed_type="file",
            threads=threads or 0, engine=engine, device=device,
        )
        back = ver.decompress(comp, delta_second_data=delta_file)
        if bytes(back) != data:
            die("Verification FAILED: decompressed bytes differ")
        print("Verification OK")
    if test:
        return None
    with open(output_file, "wb") as f:
        f.write(comp)
    return output_file


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Delta-compress a file vs a base file.")
    p.add_argument("input_file", type=str)
    p.add_argument("delta_file", type=str, help="same-length base file to XOR against")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--streaming_chunk_size", type=str, default=None)
    p.add_argument("--delete", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--method", type=str, default="HUFFMAN")
    p.add_argument("--verification", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--threads", type=int, default=None)
    add_engine_args(p)
    a = p.parse_args(argv)
    compress_file_delta(
        a.input_file, a.delta_file, dtype=a.dtype,
        streaming_chunk_size=a.streaming_chunk_size, delete=a.delete,
        force=a.force, method=a.method, verification=a.verification,
        test=a.test, threads=a.threads, engine=a.engine, device=a.device,
    )


if __name__ == "__main__":
    main()
