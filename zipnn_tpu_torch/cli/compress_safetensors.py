"""Per-tensor compression of a safetensors file -> ``.znn.safetensors``
(reference scripts/zipnn_compress_safetensors.py).  Each float tensor is
compressed on ``--device`` (``plugins.safetensors.compress_tensor``); the
file is read by ``io.streaming.SafetensorsStreamReader`` and written by
``io.safetensors_layout``, with no ``safetensors`` package."""
from __future__ import annotations

import argparse
import os

from ..io import safetensors_layout as layout
from ..io.streaming import SafetensorsStreamReader
from ..plugins.safetensors import compress_tensor, set_compressed_tensors_metadata
from . import Timer, confirm_overwrite, die, hf_cache_replace, throughput

ST_SUFFIX = ".safetensors"
OUT_SUFFIX = ".znn.safetensors"


def compress_safetensors_file(
    filename: str,
    delete: bool = False,
    force: bool = False,
    hf_cache: bool = False,
    method=None,
    threads=None,
    device="cuda",
) -> str | None:
    if not filename.endswith(ST_SUFFIX):
        die(f"{filename} does not end in {ST_SUFFIX}")
    output = filename[: -len(ST_SUFFIX)] + OUT_SUFFIX
    if delete:
        os.remove(filename)
        print(f"Deleted {filename}")
        return None
    if not confirm_overwrite(output, force):
        print("Skipping.")
        return None

    tensors = {}
    infos = {}
    total = kept = 0
    with Timer() as t:
        rdr = SafetensorsStreamReader(filename)
        metadata = dict(rdr.metadata)
        for name in sorted(rdr.keys()):
            tensor = rdr.stored(name)
            total += tensor.numel() * tensor.element_size()
            if not tensor.dtype.is_floating_point:
                tensors[name] = tensor  # skip non-float (reference :82-84)
                kept += tensor.numel() * tensor.element_size()
                continue
            res = compress_tensor(tensor, device=device)
            if res is None:  # keep raw if compression does not shrink
                tensors[name] = tensor
                kept += tensor.numel() * tensor.element_size()
                continue
            blob, info = res
            tensors[name] = blob
            infos[name] = info
            kept += blob.numel()
    metadata.setdefault("format", "pt")
    set_compressed_tensors_metadata(infos, metadata)
    layout.write(output, tensors, metadata)
    print(
        f"Compressed {filename}: {total} -> {kept} tensor bytes "
        f"(ratio {kept / max(total, 1):.4f}), {len(infos)} tensors compressed, "
        f"{throughput(total, t.seconds)}"
    )
    if hf_cache:
        hf_cache_replace(filename, output)
    return output


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Per-tensor compress a safetensors file.")
    p.add_argument("input_file", type=str)
    p.add_argument("--delete", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--hf_cache", action="store_true")
    p.add_argument("--method", type=str, default=None)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="device the tensors are compressed on (default cuda)")
    a = p.parse_args(argv)
    compress_safetensors_file(
        a.input_file, delete=a.delete, force=a.force, hf_cache=a.hf_cache,
        method=a.method, threads=a.threads, device=a.device,
    )


if __name__ == "__main__":
    main()
