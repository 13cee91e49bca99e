"""Time the port's kernels at several chunk sizes on one NVIDIA GPU.

Run from the repository root:

    python3 time_kernels.py [--pkg DIR] [--label NAME] [--seed 0]
                            [--kernels k1,k6,k2,k7,hist,k7pc] [--chunks 16384]
                            [--max-mib 256]
                            [--chunk-sizes 256,1024,4096,8192,16384,262144]
                            [--group-symbols N] [--warp-symbols N] [--parts P]

For each chunk size, bf16 and fp32 inputs of ``--chunks`` chunks (at most
``--max-mib`` MiB) of N(0, 0.05) from ``--seed`` are made.  The golden
encoder compresses them with per-chunk tables and (bf16) with the shared
table; the containers are cached in ``zipnn_tpu_torch/_build/``.  On the
first batch of each:

* ``k1``: ``huf_pc_decode`` (bf16 per-chunk), ``k6``: ``huf_shared_decode``
  (bf16 shared), each held bit-exact against its plain version (symbols
  and ``bits_left``);
* ``k2``: ``combine_cells`` at 2 planes (bf16 per-chunk) and 4 planes
  (fp32 per-chunk) on K1's symbols, held bit-exact against its plain
  version and the original bytes;
* ``k7``: ``huf_shared_encode`` over every stream of each live plane of
  the bf16 shared encode's first batch (split on the card), held
  bit-exact against its plain version (stream bytes and ``total_bits``);
* ``hist``: ``hist_cells`` over every cell of the bf16 per-chunk encode's
  first batch, beside ``torch.bincount`` (``library_ms``), and ``k7pc``:
  ``huf_pc_encode`` over the streams of its Huffman cells, both held
  bit-exact against their plain versions (``chip_smoke.py``'s
  ``hold_pc_encode_kernels``);

and timed: the median of 5 CUDA-event timings around the call after one
warm-up (K2, K7: 3, as ``chip_smoke.py`` times them), and for K2 and K7
also the median of 5 timings of the launches alone (``launch_ms``, from
the events ``kernels.recording()`` collects), which leaves out the
wrapper's host time that dominates a launch of a few MiB.

``--pkg DIR`` puts the ``zipnn_tpu_torch`` of another checkout (for
example an unpacked parent commit) first on the path, so two trees'
kernels are timed in one call on one card; this script's own
``chip_smoke.py`` provides the helpers, and only the wrappers'
signatures, which the kernels' ports keep, are used.  ``--group-symbols
N`` sets ``GROUP_SYMBOLS`` of K1 and K6 (``huf_pc``, ``huf_shared``): the
mean stream length below which a launch decodes one stream per lane (0: a
warp per stream always; a large N: a lane per stream always).
``--warp-symbols N`` sets K7's ``huf_enc.WARP_SYMBOLS`` the same way,
where the package has it.  ``--parts P`` forces the warps each stream of
``huf_pc_encode`` takes (``huf_enc.PARTS``: 1, 2, 4, 8 or 16), where the
package splits streams; the ``huf_pc_encode`` line gives ``parts``, the
split the launch took (null for a package without one).

Prints the card's name and power limit, then one JSON line per kernel and
chunk size: ``label``, ``kernel``, ``chunk``, ``streams`` (K1, K6, K7),
``symbols`` (per stream), ``cells`` (``hist_cells``),
``ms``, ``launch_ms`` and ``plain_ms`` (K2, K7, ``hist_cells``),
``library_ms`` (``hist_cells``), ``bound_ms`` (bytes the kernel must move
over 3.35 TB/s).  Any mismatch raises.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def golden(cache: Path, x: torch.Tensor, chunk: int, profile: str) -> bytes:
    """``x`` compressed by the golden encoder at ``chunk``-byte chunks,
    cached in ``cache``."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415

    tag = str(x.dtype).replace("torch.", "")
    f = cache / f"time_{tag}_{x.numel() * x.element_size()}_c{chunk}_{profile}.znn"
    if not f.exists():
        comp = ZipNN(input_format="torch", engine="numpy", huffman_table=profile,
                     compression_chunk=chunk).compress(x)
        cache.mkdir(parents=True, exist_ok=True)
        f.write_bytes(comp)
    return f.read_bytes()


def launch_ms(fn, reps: int = 5) -> float:
    """Median device milliseconds of the kernels one ``fn()`` launches,
    from the CUDA events ``kernels.launch`` records right around each
    launch (no wrapper, allocation or Python time), after one warm-up."""
    from zipnn_tpu_torch.ops import kernels  # noqa: PLC0415

    fn()
    with kernels.recording() as events:
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    per = len(events) // reps
    return statistics.median(
        sum(s.elapsed_time(e) for _, s, e in events[i * per : (i + 1) * per])
        for i in range(reps))


def _load_smoke():
    """This checkout's ``chip_smoke.py``, whatever ``--pkg`` puts first."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkg", default=str(ROOT),
                    help="directory that holds the zipnn_tpu_torch to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="k1,k6,k2,k7,hist,k7pc")
    ap.add_argument("--chunks", type=int, default=16384)
    ap.add_argument("--max-mib", type=int, default=256)
    ap.add_argument("--chunk-sizes", default="256,1024,4096,8192,16384,262144")
    ap.add_argument("--group-symbols", type=int, default=None)
    ap.add_argument("--warp-symbols", type=int, default=None)
    ap.add_argument("--parts", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    sys.path.insert(0, str(Path(args.pkg).resolve()))
    cs = _load_smoke()
    from zipnn_tpu_torch.ops import huf_enc, huf_pc, huf_shared  # noqa: PLC0415

    cs.check(Path(huf_pc.__file__).resolve().is_relative_to(Path(args.pkg).resolve()),
             f"zipnn_tpu_torch came from {huf_pc.__file__}, not --pkg")
    if args.group_symbols is not None:
        huf_pc.GROUP_SYMBOLS = huf_shared.GROUP_SYMBOLS = args.group_symbols
    if args.warp_symbols is not None and hasattr(huf_enc, "WARP_SYMBOLS"):
        huf_enc.WARP_SYMBOLS = args.warp_symbols
    if args.parts is not None and hasattr(huf_enc, "PARTS"):
        huf_enc.PARTS = args.parts
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    print(f"{smi}; zipnn_tpu_torch from {Path(huf_pc.__file__).parent.parent}",
          flush=True)
    which = set(args.kernels.split(","))

    def k2_launch_ms(k2a):
        from zipnn_tpu_torch.ops import combine  # noqa: PLC0415

        out = torch.empty(-(-k2a[6] // 4) * 4, dtype=torch.uint8, device=dev)
        return launch_ms(lambda: combine.combine_cells(*k2a, out))

    dev = torch.device("cuda")
    cache = ROOT / "zipnn_tpu_torch" / "_build"

    def emit(kernel, chunk, **kw):
        print(json.dumps({"label": args.label, "group_symbols": args.group_symbols,
                          "warp_symbols": args.warp_symbols, "parts_forced": args.parts,
                          "kernel": kernel,
                          "chunk": chunk, **kw}), flush=True)

    for chunk in (int(c) for c in args.chunk_sizes.split(",")):
        n = min(args.chunks, (args.max_mib << 20) // chunk) * chunk
        x = cs.synth(torch.bfloat16, n, args.seed)
        for profile in ("per_chunk", "shared"):
            if not which & ({"k1", "k2"} if profile == "per_chunk" else {"k6"}):
                continue
            plan, dv, (lo, hi) = cs.plan_of(golden(cache, x, chunk, profile), dev)
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
            S = int(a[1].numel())
            if ("k6" if plan.shared else "k1") in which:
                ms = cs.cuda_ms(lambda: fn(*a), reps=5)
                nbytes = (int(a[2].sum()) + S * (8 + 4 + 4 + 8 + 4) + table_bytes
                          + a[-1] + 4 * S)
                emit(name, chunk, streams=S, symbols=float(a[5].double().mean()), ms=ms,
                     bound_ms=1e3 * nbytes / cs.HBM_BYTES_PER_S)
            if "k2" in which and not plan.shared:
                k2a = dv.k2_args(lo, hi, sym_k)
                r = cs.hold_combine(f"combine_cells (2 planes, {chunk} B chunks)", plan,
                                    k2a, x, lo, hi)
                emit("combine_cells/2", chunk, ms=r["ms"], launch_ms=k2_launch_ms(k2a),
                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"])
            del dv, sym_k, sym_p, bl_k, bl_p, a
        if "k2" in which:
            x4 = cs.synth(torch.float32, n, args.seed)
            plan, dv, (lo, hi) = cs.plan_of(golden(cache, x4, chunk, "per_chunk"), dev)
            sym, _ = huf_pc.huf_pc_decode(*dv.k1_args(lo, hi))
            k2a = dv.k2_args(lo, hi, sym)
            r = cs.hold_combine(f"combine_cells (4 planes, {chunk} B chunks)", plan,
                                k2a, x4, lo, hi)
            emit("combine_cells/4", chunk, ms=r["ms"], launch_ms=k2_launch_ms(k2a),
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"])
            del x4, dv, sym
        if "k7" in which:
            g, planes, tables = cs.encode_first_batch(x, dev, chunk)
            r = cs.hold_huf_encode(g, planes, tables, dev)
            k, nb, w = planes.shape
            cells = torch.arange(k, dtype=torch.int64, device=dev)[:, None] * nb
            quarter = torch.arange(4, dtype=torch.int64, device=dev) * (w // 4)
            streams = {b: ((cells + b) * w + quarter).reshape(-1) for b in tables}
            lms = launch_ms(lambda: [huf_enc.huf_shared_encode(planes, t, g.seg, streams[b])
                                     for b, t in tables.items()])
            emit("huf_shared_encode", chunk, streams=4 * k * len(tables), symbols=g.seg,
                 ms=r["ms"], launch_ms=lms, plain_ms=r["plain_ms"], bound_ms=r["bound_ms"])
            del planes, tables
        if which & {"hist", "k7pc"}:
            from zipnn_tpu_torch.ops import hist  # noqa: PLC0415

            hk, k7, b = cs.hold_pc_encode_kernels(x, dev, chunk, min_chunks=1)
            cells = int(b["rows"].shape[0])
            if "hist" in which:
                emit("hist_cells", chunk, cells=cells, ms=hk["ms"],
                     launch_ms=launch_ms(lambda: hist.hist_cells(b["rows"])),
                     plain_ms=hk["plain_ms"], library_ms=hk["library_ms"],
                     bound_ms=hk["bound_ms"])
            if "k7pc" in which:
                emit("huf_pc_encode", chunk, streams=int(b["streams"].numel()),
                     symbols=b["seg"], parts=k7["parts"], ms=k7["ms"],
                     plain_ms=k7["plain_ms"],
                     launch_ms=launch_ms(lambda: huf_enc.huf_pc_encode(
                         b["planes"], b["tables"], b["seg"], b["streams"])),
                     bound_ms=k7["bound_ms"])
            del b
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
