"""Time the port's decode, or with ``--encode`` its encode, end to end on
one NVIDIA GPU, repeatedly, so that two trees are compared in one call.

Run from the repository root:

    python3 time_decode.py [--pkg DIR] [--label NAME] [--seed 0] [--mib 512]
                           [--reps 3] [--batch-mib 32,64,128,512] [--staging]
                           [--encode] [--fetch]

Inputs are N(0, 0.05) from ``--seed``, made on the card with a seeded
``torch.Generator`` (the same bytes on every tree) and written by the
package's own card encoder (``ZipNN(engine="cuda")``, byte-identical to
the golden encoder: ``chip_smoke.py`` phase 6 holds it).

* ``paths``: ``chip_smoke.py`` phase 4's three paths (bf16 and fp32
  per-chunk, bf16 shared; ``--mib`` MiB + a ragged tail), each decoded by
  ``ZipNN(input_format="torch", engine="cuda").decompress`` once cold and
  ``--reps`` times more, bit-exact;
* ``serving``: ``chip_smoke.py`` phase 7's Llama-3-8B two-layer load (18
  tensors, ~832 MiB), by one ``ZipNN.decompress`` per container in a row
  and, where the package has ``io.serving``, by
  ``ShardDecoder(to_device=True)`` ``decompress_iter``, ``decompress_all``
  and a staged ``decompress_groups`` replay, ``--reps`` times each;
* ``--batch-mib``: the bf16 per-chunk path and the load's
  ``decompress_iter`` at each ``decode.BATCH_BYTES``, the sizes taken in
  turn within each of ``--reps`` rounds;
* ``--staging``: the bf16 per-chunk container's cell bytes (what the
  decode copies to the card) moved three ways, ``--reps`` times after one
  cold run: ``torch`` (``staging.upload``: ``copy_`` into pinned pieces,
  each sent with ``non_blocking=True`` on the copy stream), ``native``
  (the same pieces filled by the native core's threads,
  ``native.splice_cells``) and ``register`` (``cudaHostRegister`` of the
  caller's buffer, one copy from it, ``cudaHostUnregister``).

``--encode`` times the encode instead, on the same inputs:

* ``encode``: the four 512 MiB encodes from CUDA tensors (bf16 and fp32,
  per-chunk and shared profiles), each by ``ZipNN(input_format="torch",
  engine="cuda").compress`` once cold and ``--reps`` times more; every
  container's SHA-1 is printed, so two trees' containers compare;
* ``save``: the load's 18 tensors saved by one ``ZipNN.compress`` per
  tensor and, where the package has ``io.serving.ShardEncoder``, by its
  ``compress_iter`` with ``pool_staging`` off and on (page-locked pooled
  buffers) and on with pageable pooled buffers (its ``_out_acquire``
  asked for pageable ones), both profiles, ``--reps`` times each (the
  first round finds the pools cold).

``--fetch`` times what bounds the encode's fetch: ``--mib`` MiB of bytes
on the card brought to the host by ``staging.download`` into a new
``codec.frame`` (fresh pages), into one whose pages a single thread
touched first (the touch timed apart) and into page-locked memory,
``--reps`` times after one cold run.

``--pkg DIR`` puts the ``zipnn_tpu_torch`` of another checkout (for
example an unpacked parent commit) first on the path; the helpers come
from this script's ``chip_smoke.py``.  Prints the card's name and power
limit, then one JSON line per measurement: ``label``, ``what``, ``rep``
(0 = the first, cold call), ``wall_s``, ``GBps`` (original bytes over the
wall) and the phase seconds where the package reports them.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phases(t: dict) -> dict:
    return {k: t[k] for k in ("plan_s", "stage_s", "upload_s") if k in t}


def enc_phases(t: dict) -> dict:
    """Every phase second the tree's ``encode.last_timings`` holds."""
    return {k: v for k, v in t.items() if k.endswith("_s")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=None)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch-mib", default="")
    ap.add_argument("--staging", action="store_true")
    ap.add_argument("--encode", action="store_true")
    ap.add_argument("--fetch", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_decode: no CUDA device")
    sys.path.insert(0, str(Path(args.pkg).resolve() if args.pkg else ROOT))
    smoke = _load_smoke()
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode  # noqa: PLC0415

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(f"{args.label}: {sys.modules['zipnn_tpu_torch'].__file__} on {smi}", flush=True)
    try:
        from zipnn_tpu_torch.io.serving import ShardDecoder  # noqa: PLC0415
    except ModuleNotFoundError:  # a tree from before the serving module
        ShardDecoder = None

    def emit(what, rep, wall, nbytes, **kw):
        print(json.dumps({"label": args.label, "what": what, "rep": rep, "wall_s": wall,
                          "GBps": nbytes / wall / 1e9, **kw}), flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.mib << 20
    x_bf16 = (torch.randn(n // 2 + 3001, generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    x_fp32 = torch.randn(n // 4 + 1501, generator=gen, device=dev) * 0.05
    if args.encode:
        encode_mode(args, smoke, dev, emit, x_bf16, x_fp32)
        return
    if args.fetch:
        fetch_ways(x_bf16.view(torch.uint8)[:n], args.reps, emit)
        return
    paths = {
        "bf16 per-chunk": (x_bf16, ZipNN(input_format="torch", engine="cuda").compress(x_bf16)),
        "fp32 per-chunk": (x_fp32, ZipNN(input_format="torch", engine="cuda").compress(x_fp32)),
        "bf16 shared": (x_bf16, ZipNN(input_format="torch", engine="cuda",
                                      huffman_table="shared").compress(x_bf16)),
    }

    def decode_path(what, x, comp, rep):
        ints = torch.int16 if x.element_size() == 2 else torch.int32
        y, wall = timed(lambda: ZipNN(input_format="torch", engine="cuda").decompress(comp))
        if not torch.equal(y.view(ints), x.view(ints)):
            raise RuntimeError(f"{what}: decoded != original")
        del y
        emit(what, rep, wall, x.numel() * x.element_size(), **phases(decode.last_timings),
             kernel_ms=decode.kernel_ms())

    for what, (x, comp) in paths.items():
        for rep in range(args.reps + 1):
            decode_path(what, x, comp, rep)

    names, xs, blobs = smoke.llama_load(args.seed + 20, dev)
    load_bytes = sum(x.numel() * 2 for x in xs)

    def check_load(outs, way):
        for name, x, y in zip(names, xs, outs):
            if not torch.equal(y.view(torch.int16).reshape(-1), x.view(torch.int16).reshape(-1)):
                raise RuntimeError(f"{way}: {name} != original")

    def summed(timings):
        return {k: sum(t.get(k, 0.0) for t in timings) for k in ("plan_s", "stage_s", "upload_s")}

    def per_container():
        outs, timings = [], []
        for b in blobs:
            outs.append(ZipNN(engine="cuda").decompress(b))
            timings.append(dict(decode.last_timings))
        return outs, timings

    ways = {"ZipNN.decompress per container": per_container}
    if ShardDecoder is not None:
        dec = ShardDecoder(to_device=True)
        units = dec.stack_groups([dec.stage(b) for b in blobs])
        ways["decompress_iter"] = lambda: (list(dec.decompress_iter(blobs)), dec.timings)
        ways["decompress_all"] = lambda: (dec.decompress_all(blobs), dec.timings)
        ways["decompress_groups (staged)"] = lambda: (dec.decompress_groups(units), dec.timings)
    for rep in range(args.reps):
        for way, fn in ways.items():
            (outs, timings), wall = timed(fn)
            if rep == 0:
                check_load(outs, way)
            del outs
            emit(f"serving: {way}", rep, wall, load_bytes, **summed(timings))

    sizes = [int(v) for v in args.batch_mib.split(",") if v]
    for rep in range(args.reps if sizes else 0):
        for mib in sizes:
            decode.BATCH_BYTES = mib << 20
            x, comp = paths["bf16 per-chunk"]
            decode_path(f"bf16 per-chunk, batch {mib} MiB", x, comp, rep)
            if ShardDecoder is not None:
                (outs, timings), wall = timed(ways["decompress_iter"])
                check_load(outs, "decompress_iter")
                del outs
                emit(f"serving: decompress_iter, batch {mib} MiB", rep, wall, load_bytes,
                     **summed(timings))

    if args.staging:
        staging_ways(paths["bf16 per-chunk"][1], args.reps, emit)


def encode_mode(args, smoke, dev, emit, x_bf16, x_fp32) -> None:
    """The ``--encode`` measurements (see the module's docstring)."""
    import hashlib  # noqa: PLC0415

    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import encode  # noqa: PLC0415

    try:
        from zipnn_tpu_torch.io import serving  # noqa: PLC0415
    except ModuleNotFoundError:
        serving = None
    shard_encoder = getattr(serving, "ShardEncoder", None)
    for what, x in (("bf16", x_bf16), ("fp32", x_fp32)):
        for profile in ("per_chunk", "shared"):
            z = ZipNN(input_format="torch", engine="cuda", huffman_table=profile)
            for rep in range(args.reps + 1):
                comp, wall = timed(lambda: z.compress(x))
                emit(f"encode: {what} {profile}", rep, wall, x.numel() * x.element_size(),
                     sha1=hashlib.sha1(comp).hexdigest(), size=len(comp),
                     **enc_phases(encode.last_timings))
                del comp

    names, xs = smoke.llama_tensors_on_card(args.seed + 20, dev)
    load_bytes = sum(x.numel() * 2 for x in xs)

    def summed(timings):
        keys = sorted({k for t in timings for k in t if k.endswith("_s")})
        return {k: sum(t.get(k, 0.0) for t in timings) for k in keys}

    for profile in ("per_chunk", "shared"):
        z = ZipNN(input_format="torch", engine="cuda", huffman_table=profile)

        def per_tensor(consume):
            timings = []
            for x in xs:
                consume(z.compress(x))
                timings.append(dict(encode.last_timings))
            return timings

        def iterate(enc):
            def way(consume):
                for c in enc.compress_iter(xs):
                    consume(c)
                return enc.timings
            return way

        ways = {"ZipNN.compress per tensor": per_tensor}
        if shard_encoder is not None:
            ways["compress_iter"] = iterate(shard_encoder(z))
            pooled = ways["compress_iter, pool_staging"] = iterate(
                shard_encoder(z, pool_staging=True))
            acquire = serving._out_acquire

            def pageable(consume, pooled=pooled):
                serving._out_pool.clear()
                serving._out_acquire = lambda need, pinned: acquire(need, False)
                try:
                    return pooled(consume)
                finally:
                    serving._out_acquire = acquire
                    serving._out_pool.clear()

            ways["compress_iter, pool_staging, pageable"] = pageable
        want = None
        for rep in range(args.reps + 1):
            for way, fn in ways.items():
                # the first round finds the pools cold and hashes each container as
                # it arrives (a pooled one is valid for two more); later ones only
                # take its length, as a writer's cheapest consumer would
                digests: list = []
                consume = (lambda c: digests.append(hashlib.sha1(c).digest())) if rep == 0 else len
                timings, wall = timed(lambda: fn(consume))
                kw = {}
                if rep == 0:
                    kw["sha1"] = hashlib.sha1(b"".join(digests)).hexdigest()
                    want = want or kw["sha1"]
                    if kw["sha1"] != want:
                        raise RuntimeError(f"save {profile} {way}: containers differ")
                emit(f"save: {profile} {way}", rep, wall, load_bytes, **kw, **summed(timings))


def fetch_ways(src: torch.Tensor, reps: int, emit) -> None:
    """``src`` (bytes on the card) into host memory three ways (see the
    module's docstring), each checked byte-equal once."""
    from zipnn_tpu_torch import codec  # noqa: PLC0415
    from zipnn_tpu_torch.ops import staging  # noqa: PLC0415

    n = src.numel()
    pool = staging.pool(src.device)
    want = src[:4096].cpu().numpy()
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)

    def touched():
        out = codec.frame(n)
        t0 = time.perf_counter()
        out[::4096] = 0
        return out, time.perf_counter() - t0

    ways = {"fresh": lambda: (codec.frame(n), 0.0), "touched": touched,
            "page-locked": lambda: (pinned, 0.0)}
    for rep in range(reps + 1):
        for way, make in ways.items():
            out, touch_s = make()
            t = {}
            _, wall = timed(lambda: staging.download(pool, src, out, [(0, 0, n)], t))
            head = out[:4096].numpy() if isinstance(out, torch.Tensor) else out[:4096]
            if not np.array_equal(head, want):
                raise RuntimeError(f"fetch {way}: bytes differ")
            emit(f"fetch: {way}", rep, wall, n, touch_s=touch_s, **t)
            del out


def staging_ways(comp: bytes, reps: int, emit) -> None:
    """The container's cell bytes to the card three ways (see the module's
    docstring), each checked byte-equal on the card once."""
    from zipnn_tpu_torch import ZipNN, native  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode, staging  # noqa: PLC0415

    z = ZipNN(engine="cuda")
    after = z._retrieve_header(memoryview(comp))
    plan = decode.build_plan(memoryview(comp)[after:], 2, z._bit_reorder, z._byte_reorder,
                             z.compression_chunk, z.original_len)
    src_np = plan.g.payload_np
    src = staging.as_tensor(src_np)
    lo = int(plan.g.cell_start.min())
    ranges = [(lo, src_np.size - lo)]
    nbytes = src_np.size - lo
    want = src[lo:].to("cuda")
    dst = torch.empty(src_np.size, dtype=torch.uint8, device="cuda")
    pool = staging.pool("cuda")
    threads = os.cpu_count() or 1

    def by_torch():
        return staging.upload(pool, src, dst, ranges, {})

    def by_native():
        with torch.cuda.stream(pool.stream):
            for o in range(lo, src_np.size, staging.PIECE_BYTES):
                m = min(staging.PIECE_BYTES, src_np.size - o)
                buf = pool.acquire(m)
                k = 8 * threads  # ztpu_splice_cells gives each thread runs of 8 cells
                starts = np.arange(0, m, -(-m // k), dtype=np.int64)
                c = starts.size
                native.splice_cells(
                    buf.numpy(), starts, np.zeros(c, np.uint8),
                    np.diff(np.append(starts, m)), np.zeros(c, np.uint8),
                    np.zeros(c, np.int64), np.zeros(0, np.uint8), np.zeros(0, np.int64),
                    np.zeros(0, np.int64), np.zeros((c, 3), np.uint16), o + starts, src_np)
                dst[o : o + m].copy_(buf[:m], non_blocking=True)
                done = torch.cuda.Event()
                done.record(pool.stream)
                pool.release(buf, done)
        pool.stream.synchronize()

    def by_register():
        cudart = torch.cuda.cudart()
        ptr = src_np.ctypes.data
        err = cudart.cudaHostRegister(ptr, src_np.size, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister failed: {err}")
        try:
            dst[lo:].copy_(src[lo:], non_blocking=True)
            torch.cuda.synchronize()
        finally:
            cudart.cudaHostUnregister(ptr)

    for way, fn in (("torch", by_torch), ("native", by_native), ("register", by_register)):
        for rep in range(reps + 1):
            dst.zero_()
            _, wall = timed(fn)
            if rep == 0 and not torch.equal(dst[lo:], want):
                raise RuntimeError(f"staging {way}: bytes on the card differ")
            emit(f"staging: {way}", rep, wall, nbytes)


if __name__ == "__main__":
    main()
