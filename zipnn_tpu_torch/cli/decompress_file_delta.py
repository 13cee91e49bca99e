"""Decompress a delta-compressed ``.znn`` against its base file
(reference scripts/zipnn_decompress_file_delta.py)."""
from __future__ import annotations

import argparse
import os

from ..zipnn import ZipNN
from . import SUFFIX, Timer, add_engine_args, confirm_overwrite, die, throughput


def decompress_file_delta(
    input_file: str,
    delta_file: str,
    delete: bool = False,
    force: bool = False,
    threads=None,
    engine: str = "cuda",
    device="cuda",
) -> str | None:
    for f in (input_file, delta_file):
        if not os.path.isfile(f):
            die(f"No such file: {f}")
    if not input_file.endswith(SUFFIX):
        die(f"{input_file} does not end in {SUFFIX}")
    output_file = input_file[: -len(SUFFIX)]
    if not confirm_overwrite(output_file, force):
        print("Skipping.")
        return None
    znn = ZipNN(
        is_streaming=True, delta_compressed_type="file",
        threads=threads or 0, engine=engine, device=device,
    )
    with open(input_file, "rb") as f:
        comp = f.read()
    with Timer() as t:
        data = znn.decompress(comp, delta_second_data=delta_file)
    with open(output_file, "wb") as f:
        f.write(data)
    print(
        f"Delta-decompressed {input_file} vs {delta_file}: {len(data)} bytes, "
        f"{throughput(len(data), t.seconds)}"
    )
    if delete:
        os.remove(input_file)
    return output_file


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Decompress a delta .znn vs a base file.")
    p.add_argument("input_file", type=str)
    p.add_argument("delta_file", type=str)
    p.add_argument("--delete", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--threads", type=int, default=None)
    add_engine_args(p)
    a = p.parse_args(argv)
    decompress_file_delta(
        a.input_file, a.delta_file, delete=a.delete, force=a.force,
        threads=a.threads, engine=a.engine, device=a.device,
    )


if __name__ == "__main__":
    main()
