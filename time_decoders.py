"""Time the Huffman decode kernels K1 and K6 at small chunk sizes on one
NVIDIA GPU.

Run from the repository root:

    python3 time_decoders.py [--pkg DIR] [--label NAME] [--seed 0]
                             [--chunks 16384] [--chunk-sizes 256,1024,4096,8192,16384]
                             [--group-symbols N]

For each chunk size, a bf16 input of ``--chunks`` chunks of N(0, 0.05)
from ``--seed`` is compressed by the golden encoder twice: with per-chunk
tables (decoded by K1, ``huf_pc_decode``) and with the shared table (K6,
``huf_shared_decode``).  The containers are cached in
``zipnn_tpu_torch/_build/``.  Each container's first batch is decoded by
its kernel, held bit-exact against the plain version (symbols and
``bits_left``), and timed: the median of 5 CUDA-event timings after one
warm-up.  Short chunks give short streams (about 128 symbols per stream at
1 KB chunks), where a warp-per-stream decoder has few sub-segments to run
in parallel.

``--pkg DIR`` puts the ``zipnn_tpu_torch`` of another checkout (for
example an unpacked parent commit) first on the path, so two trees'
kernels are timed in one call on one card.  Only the wrappers'
signatures, which the kernels' ports keep, are used.  ``--group-symbols
N`` sets ``GROUP_SYMBOLS`` of both kernels (``huf_pc``, ``huf_shared``),
the mean stream length below which a launch decodes one stream per lane
(0: a warp per stream always; a large N: a lane per stream always).

Prints the card's name and power limit, then one JSON line per kernel and
chunk size: ``label``, ``kernel``, ``chunk``, ``streams``, ``symbols``
(mean per stream), ``ms``, ``bound_ms`` (bytes the kernel must move over
3.35 TB/s).  Any mismatch raises.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def golden(cache: Path, x: torch.Tensor, chunk: int, profile: str) -> bytes:
    """``x`` compressed by the golden encoder at ``chunk``-byte chunks,
    cached in ``cache``."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415

    f = cache / f"time_bf16_{x.numel() * 2}_c{chunk}_{profile}.znn"
    if not f.exists():
        comp = ZipNN(input_format="torch", engine="numpy", huffman_table=profile,
                     compression_chunk=chunk).compress(x)
        cache.mkdir(parents=True, exist_ok=True)
        f.write_bytes(comp)
    return f.read_bytes()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkg", default=str(ROOT),
                    help="directory that holds the zipnn_tpu_torch to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunks", type=int, default=16384)
    ap.add_argument("--chunk-sizes", default="256,1024,4096,8192,16384")
    ap.add_argument("--group-symbols", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_decoders: no CUDA device")
    sys.path.insert(0, str(Path(args.pkg).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs  # noqa: PLC0415
    from zipnn_tpu_torch.ops import huf_pc, huf_shared  # noqa: PLC0415

    cs.check(Path(huf_pc.__file__).resolve().is_relative_to(Path(args.pkg).resolve()),
             f"zipnn_tpu_torch came from {huf_pc.__file__}, not --pkg")
    if args.group_symbols is not None:
        huf_pc.GROUP_SYMBOLS = huf_shared.GROUP_SYMBOLS = args.group_symbols
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    print(f"{smi}; zipnn_tpu_torch from {Path(huf_pc.__file__).parent.parent}",
          flush=True)
    dev = torch.device("cuda")
    cache = ROOT / "zipnn_tpu_torch" / "_build"
    for chunk in (int(c) for c in args.chunk_sizes.split(",")):
        x = cs.synth(torch.bfloat16, args.chunks * chunk, args.seed)
        for profile in ("per_chunk", "shared"):
            comp = golden(cache, x, chunk, profile)
            plan, dv, (lo, hi) = cs.plan_of(comp, dev)
            cs.check(plan.shared == (profile == "shared"), f"{profile} plan")
            if plan.shared:
                name, fn, plain = ("huf_shared_decode", huf_shared.huf_shared_decode,
                                   huf_shared.huf_shared_decode_plain)
                a = dv.k6_args(lo, hi)
                table_bytes = 512
            else:
                name, fn, plain = ("huf_pc_decode", huf_pc.huf_pc_decode,
                                   huf_pc.huf_pc_decode_plain)
                a = dv.k1_args(lo, hi)
                table_bytes = 4 * (a[6].numel() + a[7].numel()) + 2 * a[8].numel()
            sym_k, bl_k = fn(*a)
            sym_p, bl_p = plain(*a)
            cs.check(torch.equal(sym_k, sym_p) and torch.equal(bl_k, bl_p),
                     f"{name} at {chunk} B chunks != plain")
            ms = cs.cuda_ms(lambda: fn(*a), reps=5)
            S = int(a[1].numel())
            nbytes = (int(a[2].sum()) + S * (8 + 4 + 4 + 8 + 4) + table_bytes
                      + a[-1] + 4 * S)
            print(json.dumps({
                "label": args.label, "group_symbols": args.group_symbols,
                "kernel": name, "chunk": chunk, "streams": S,
                "symbols": float(a[5].double().mean()), "ms": ms,
                "bound_ms": 1e3 * nbytes / cs.HBM_BYTES_PER_S,
            }), flush=True)
            del dv, sym_k, sym_p, bl_k, bl_p, a
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
