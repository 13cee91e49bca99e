"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--mib 512]

It needs a CUDA device and ``nvcc`` (it builds the kernels from
``zipnn_tpu_torch/csrc/*.cu``) and no network.  Phases:

1. build the kernels;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path's first batch (bit-exact);
3. decode the committed fixtures ``tests/fixtures/{bf16_gauss,fp16_mixed,
   fp8_gauss}.znn`` through ``ZipNN(engine="cuda")``;
4. the main path: a bf16 buffer of ``--mib`` MiB + 6002 bytes, N(0, 0.05)
   from ``--seed``, compressed with the golden encoder and decompressed by
   ``ZipNN(input_format="torch", engine="cuda")`` into a CUDA tensor that
   must equal the original, with the kernels' launches counted;
5. a flipped bit inside a Huffman stream must raise ``CorruptChunkError``
   naming its plane, chunk and stream.

It prints a ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Any failure raises, so
the exit code is not 0 and no result line is printed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
TAIL = 6002


def log(*a):
    print(*a, flush=True)


def check(ok, what) -> None:
    """Fail the run (not an ``assert``: those vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int = 3) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` timed runs
    after one warm-up, with CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def synth_bf16(nbytes: int, seed: int) -> np.ndarray:
    """N(0, 0.05) bf16 bit patterns (the upper half of each float32)."""
    rng = np.random.default_rng(seed)
    out = np.empty(nbytes // 2, dtype=np.uint16)
    step = 32 << 20
    for off in range(0, out.size, step):
        n = min(step, out.size - off)
        vals = (rng.standard_normal(n) * 0.05).astype(np.float32)
        out[off : off + n] = (vals.view(np.uint32) >> 16).astype(np.uint16)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=512)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, str(ROOT))
    from zipnn_tpu_torch import CorruptChunkError, ZipNN, codec  # noqa: PLC0415
    from zipnn_tpu_torch.ops import combine, decode, huf_pc, kernels  # noqa: PLC0415

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    kernels.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("[build]", line.strip())

    # ---- main-path container ---------------------------------------------
    nbytes = (args.mib << 20) + TAIL
    raw = synth_bf16(nbytes, args.seed)
    x_cpu = torch.from_numpy(raw).view(torch.bfloat16)
    cache = kernels.BUILD_DIR / f"smoke_bf16_s{args.seed}_{nbytes}.znn"
    t0 = time.perf_counter()
    if cache.exists():
        container = cache.read_bytes()
        log(f"[main] container read from {cache.name}")
    else:
        container = ZipNN(input_format="torch", engine="numpy").compress(x_cpu)
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_bytes(container)
    log(f"[main] {nbytes} bytes -> {len(container)} bytes "
        f"(ratio {len(container) / nbytes:.4f}) in {time.perf_counter() - t0:.1f} s")

    # ---- 2. kernels against their plain versions ------------------------
    zp = ZipNN(engine="cuda")
    after = zp._retrieve_header(memoryview(container))
    payload = memoryview(container)[after:]
    plan = decode.build_plan(payload, 2, zp._bit_reorder, zp._byte_reorder,
                             zp.compression_chunk, zp.original_len)
    dv = decode.DeviceInputs(plan, dev)
    lo, hi = decode.plan_batches(plan.g.n_chunks, plan.g.chunk_size)[0]
    hi = min(hi, nbytes // plan.g.chunk_size)  # full chunks only
    check(hi - lo >= 64, f"first batch has {hi - lo} full chunks, want >= 64")
    k1a = dv.k1_args(lo, hi)
    sym_k, bl_k = huf_pc.huf_pc_decode(*k1a)
    t0 = time.perf_counter()
    sym_p, bl_p = huf_pc.huf_pc_decode_plain(*k1a)
    torch.cuda.synchronize()
    k1_plain_ms = 1e3 * (time.perf_counter() - t0)
    k1_err = int((sym_k.int() - sym_p.int()).abs().max())
    check(torch.equal(sym_k, sym_p) and torch.equal(bl_k, bl_p), "K1 != plain")
    check(int(bl_k.abs().max()) == 0, "K1 streams not fully consumed")
    k1_ms = cuda_ms(lambda: huf_pc.huf_pc_decode(*k1a))
    S = int(k1a[1].numel())
    k1_bytes = (int(k1a[2].sum()) + S * (8 + 4 + 4 + 8 + 4 + 4)
                + int(k1a[7].numel()) * 4 + int(k1a[8].numel()) * 2
                + k1a[9] + 4 * S)
    distinct = int(torch.unique(dv.tables, dim=0).shape[0])
    log(f"[kernels] huf_pc_decode: {hi - lo} chunks, {S} streams, "
        f"{k1_ms:.3f} ms (plain {k1_plain_ms:.1f} ms), bit-exact; the plan "
        f"has {plan.n_huf} Huffman cells with {distinct} distinct tables")

    k2a = dv.k2_args(lo, hi, sym_k)
    total = k2a[6]
    out_k = torch.empty(-(-total // 4) * 4, dtype=torch.uint8, device=dev)
    out_p = torch.empty_like(out_k)
    combine.combine_cells(*k2a, out_k)
    t0 = time.perf_counter()
    combine.combine_cells_plain(*k2a, out_p)
    torch.cuda.synchronize()
    k2_plain_ms = 1e3 * (time.perf_counter() - t0)
    k2_err = int((out_k.int() - out_p.int()).abs().max())
    check(torch.equal(out_k, out_p), "K2 != plain")
    check(torch.equal(out_k[:total].cpu(), x_cpu.view(torch.uint8)[:total]), "K2 output != original")
    k2_ms = cuda_ms(lambda: combine.combine_cells(*k2a, out_k))
    want = plan.g.want[:, lo:hi]
    kind = plan.g.kind[:, lo:hi]
    k2_bytes = (int(want[kind != decode.KIND_RLE].sum())
                + 12 * int(k2a[2].numel()) + out_k.numel())
    log(f"[kernels] combine_cells: {hi - lo} chunks, {k2_ms:.3f} ms "
        f"(plain {k2_plain_ms:.1f} ms), bit-exact")
    del dv, sym_k, sym_p, out_k, out_p

    # ---- 3. fixtures ----------------------------------------------------
    fix = ROOT / "tests" / "fixtures"
    for fx in ("bf16_gauss", "fp16_mixed", "fp8_gauss"):
        got = ZipNN(engine="cuda").decompress((fix / f"{fx}.znn").read_bytes())
        check(bytes(got) == (fix / f"{fx}.raw").read_bytes(), fx)
        log(f"[fixtures] {fx}: bit-exact")

    # ---- 4. main path ---------------------------------------------------
    x_dev = x_cpu.to(dev)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = ZipNN(input_format="torch", engine="cuda").decompress(container)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    kms = decode.kernel_ms()
    timings = dict(decode.last_timings)
    check(y.is_cuda and y.dtype == torch.bfloat16 and y.shape == x_cpu.shape,
          f"main path gave {y.device} {y.dtype} {tuple(y.shape)}")
    check(torch.equal(y.view(torch.int16), x_dev.view(torch.int16)), "main path mismatch")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} not launched on the main path")
    del y
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = ZipNN(input_format="torch", engine="cuda").decompress(container)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    check(torch.equal(y.view(torch.int16), x_dev.view(torch.int16)), "second main-path run mismatch")
    del y, x_dev
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    log(f"[main] {nbytes} bytes bf16 -> CUDA tensor, bit-exact; "
        f"plan {timings['plan_s']:.3f} s, upload {timings['upload_s']:.3f} s, "
        f"K1 {kms['huf_pc_decode']:.3f} ms, K2 {kms['combine_cells']:.3f} ms, "
        f"end to end {wall:.3f} s = {nbytes / wall / 1e9:.3f} GB/s "
        f"(second run {wall2:.3f} s = {nbytes / wall2 / 1e9:.3f} GB/s); "
        f"launches {launches}; card: {smi}")

    # ---- 5. corruption --------------------------------------------------
    comp = (fix / "bf16_gauss.znn").read_bytes()
    zc = ZipNN(engine="cuda")
    after = zc._retrieve_header(memoryview(comp))
    cplan = decode.build_plan(memoryview(comp)[after:], 2, zc._bit_reorder,
                              zc._byte_reorder, zc.compression_chunk, zc.original_len)
    k = 1
    s0 = after + int(cplan.starts[k])
    ln = int(cplan.lens[k])
    exp = None
    for bit in range(8 * (ln // 2), 8 * ln - 8):
        bad = bytearray(comp)
        bad[s0 + bit // 8] ^= 1 << (bit % 8)
        try:
            codec.decompress_payload_numpy(
                memoryview(bytes(bad))[after:], 2, zc._bit_reorder,
                zc._byte_reorder, zc.compression_chunk, zc.original_len)
        except CorruptChunkError as e:
            exp = (bytes(bad), e.plane, e.chunk)
            break
    check(exp is not None, "no bit flip found that the golden decoder rejects")
    try:
        ZipNN(engine="cuda").decompress(exp[0])
    except CorruptChunkError as e:
        check((e.plane, e.chunk, e.stream) == (exp[1], exp[2], k), (e, exp))
        log(f"[corrupt] bit flip in stream {k} -> {e}")
    else:
        raise RuntimeError("chip_smoke check failed: corrupt container decoded")

    # ---- 6. summary -----------------------------------------------------
    log(f"[summary] K1 pallas_huf_pc -> huf_pc_decode: {launches['huf_pc_decode']} "
        f"launches, plain match; K2 pallas_combine -> combine_cells: "
        f"{launches['combine_cells']} launches, plain match; K3 pallas_gather "
        f"row gather -> carried by huf_pc_decode (byte-offset reads): "
        f"{launches['huf_pc_decode']} launches, plain match")
    rows = [
        {"name": "huf_pc_decode", "route": "cuda",
         "source": "zipnn_tpu_torch/csrc/huf_pc.cu",
         "replaces": "zipnn_tpu/ops/pallas_huf_pc.py:425 (K1); "
                     "zipnn_tpu/ops/pallas_gather.py:84 (K3)",
         "launches": launches["huf_pc_decode"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": 1e3 * k1_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
         "library_ms": None},
        {"name": "combine_cells", "route": "cuda",
         "source": "zipnn_tpu_torch/csrc/combine.cu",
         "replaces": "zipnn_tpu/ops/pallas_combine.py:249 (K2)",
         "launches": launches["combine_cells"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": 1e3 * k2_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
         "library_ms": None},
    ]
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
