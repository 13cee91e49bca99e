"""Decompress a ``.znn.safetensors`` file back to plain safetensors
(reference scripts/zipnn_decompress_safetensors.py).  The tensors decode on
``--device`` (``plugins.safetensors.SafeOpen``'s ``decode_device``); the
output is written by ``io.safetensors_layout``, with no ``safetensors``
package."""
from __future__ import annotations

import argparse
import os

from ..io import safetensors_layout as layout
from ..plugins.safetensors import SafeOpen
from . import Timer, confirm_overwrite, die, throughput

IN_SUFFIX = ".znn.safetensors"
OUT_SUFFIX = ".safetensors"


def decompress_safetensors_file(
    filename: str,
    delete: bool = False,
    force: bool = False,
    hf_cache: bool = False,
    threads=None,
    device="cuda",
) -> str | None:
    if not filename.endswith(IN_SUFFIX):
        die(f"{filename} does not end in {IN_SUFFIX}")
    output = filename[: -len(IN_SUFFIX)] + OUT_SUFFIX
    if not confirm_overwrite(output, force):
        print("Skipping.")
        return None

    tensors = {}
    total = 0
    with Timer() as t, SafeOpen(filename, "pt", decode_device=device) as f:
        metadata = dict(f.metadata() or {})
        metadata.pop("znn_compressed_vectors", None)
        for name in f.keys():
            tensor = f.get_tensor(name)  # transparently decompresses
            tensors[name] = tensor
            total += tensor.numel() * tensor.element_size()
    layout.write(output, tensors, metadata or None)
    print(f"Decompressed {filename} -> {output}, {throughput(total, t.seconds)}")
    if delete:
        os.remove(filename)
    return output


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Decompress a .znn.safetensors file.")
    p.add_argument("input_file", type=str)
    p.add_argument("--delete", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--hf_cache", action="store_true")
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="device the tensors are decoded on (default cuda)")
    a = p.parse_args(argv)
    decompress_safetensors_file(
        a.input_file, delete=a.delete, force=a.force, hf_cache=a.hf_cache,
        threads=a.threads, device=a.device,
    )


if __name__ == "__main__":
    main()
