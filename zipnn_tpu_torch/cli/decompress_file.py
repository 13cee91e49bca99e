"""Decompress one ``.znn`` file (reference scripts/zipnn_decompress_file.py).

On ``--engine cuda`` the frames of a streaming file decode on the card
together, as one container (``ZipNN`` on ``engine="cuda"``)."""
from __future__ import annotations

import argparse
import os

from ..zipnn import ZipNN
from . import SUFFIX, Timer, add_engine_args, confirm_overwrite, die, throughput

# the last call's seconds: reading the .znn (read_s), the decompress
# (decompress_s, the one the printed GB/s is of) and writing the file (write_s)
last_timings: dict = {}


def decompress_file(
    input_file: str,
    delete: bool = False,
    force: bool = False,
    hf_cache: bool = False,
    threads=None,
    engine: str = "cuda",
    device="cuda",
) -> str | None:
    if not os.path.isfile(input_file):
        die(f"No such file: {input_file}")
    if not input_file.endswith(SUFFIX):
        die(f"{input_file} does not end in {SUFFIX}")
    output_file = input_file[: -len(SUFFIX)]
    if not confirm_overwrite(output_file, force):
        print("Skipping.")
        return None

    # decompress always walks streaming frames (reference
    # zipnn_decompress_file.py:47: is_streaming=True)
    znn = ZipNN(is_streaming=True, threads=threads or 0, engine=engine, device=device)
    with Timer() as tr, open(input_file, "rb") as f:
        comp = f.read()
    with Timer() as t:
        data = znn.decompress(comp)
    with Timer() as tw, open(output_file, "wb") as f:
        f.write(data)
    last_timings.clear()
    last_timings.update(read_s=tr.seconds, decompress_s=t.seconds, write_s=tw.seconds)
    print(
        f"Decompressed {input_file}: {len(comp)} -> {len(data)} bytes, "
        f"{throughput(len(data), t.seconds)}"
    )
    if hf_cache and os.path.islink(input_file):
        blob = os.path.join(os.path.dirname(input_file), os.readlink(input_file))
        new_blob = blob[: -len(SUFFIX)] if blob.endswith(SUFFIX) else blob
        os.rename(output_file, new_blob)
        os.symlink(new_blob, output_file)
    if delete:
        os.remove(input_file)
    return output_file


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Decompress a .znn file.")
    p.add_argument("input_file", type=str, help="Path of the file to decompress.")
    p.add_argument("--delete", action="store_true", help="delete the compressed file afterwards")
    p.add_argument("--force", action="store_true", help="overwrite without asking")
    p.add_argument("--hf_cache", action="store_true", help="file lives in the HF hub cache")
    p.add_argument("--threads", type=int, default=None)
    add_engine_args(p)
    a = p.parse_args(argv)
    decompress_file(
        a.input_file, delete=a.delete, force=a.force, hf_cache=a.hf_cache,
        threads=a.threads, engine=a.engine, device=a.device,
    )


if __name__ == "__main__":
    main()
