"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--mib 512]

It needs a CUDA device, ``nvcc`` (it builds the kernels from
``zipnn_tpu_torch/csrc/*.cu``), ``g++`` (it builds the native host core
from ``zipnn_tpu_torch/csrc/ztpu_core.cpp``) and no network.  Phases:

1. build the kernels and, at the same time, the native host core;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of its path's first batch (bit-exact): ``huf_pc_decode`` on the
   bf16 and fp32 paths, ``huf_shared_decode`` on the shared-table path
   (each with the mean and max of its synchronisation passes per stream),
   ``combine_cells`` at 2 planes (bf16) and 4 planes (fp32), the encode
   kernels ``const_scan_rows`` and ``huf_shared_encode`` on the bf16 shared
   encode path (stream bytes and ``total_bits``), ``hist_cells`` and
   ``huf_pc_encode`` on the bf16 per-chunk encode path (with the host plan
   of its cells between them, timed), and ``combine_cells`` once more at
   1 plane (8 MiB of fp8 at 64 KB chunks) and at 256 B chunks of bf16
   (1 MiB) into an output 4 bytes past a 16-byte boundary; and the native
   host core against the plain Python it replaces on the card's paths:
   ``native.build_ctables`` against ``encode.cell_table`` on every
   Huffman cell of the bf16 per-chunk encode's first batch, the native
   weight-header parse against the Python one on the bf16 per-chunk
   container (each timed); and ``splice_cells`` against its plain version
   and against the native core's splice on the same cells, at the first
   batch of the bf16 encode (both profiles: the cells phase 6 writes);
   and ``combine_cells`` at 4 planes with no sign rotation (``bit_reorder``
   0) at the first batch of phase 12's fp32 lossy INTEGER container (int32
   planes);
3. decode the committed libzstd-made fixtures ``tests/fixtures/
   {bf16_gauss,fp16_mixed,fp8_gauss,fp32_gauss}.znn`` and shared-table
   containers of bf16, fp16, fp8 and fp32 (8 MiB each from ``--seed``,
   written by the port's golden encoder) through ``ZipNN(engine="cuda")``;
   encode the same four inputs on the card, from host and CUDA tensors,
   byte-equal to the golden containers and decoded back bit-exact, in
   both profiles (the default per-chunk one through ``hist_cells`` and
   ``huf_pc_encode``), and by engine ``"native"`` (both profiles, decoded
   back); chunks of 1 and 2 bytes of every dtype and profile
   decoded on the card (``combine_cells`` byte by byte), and the encode of
   every chunk size whose planes are under one word, both profiles, from
   a CUDA tensor on the card (the sub-word route: none of the input
   uploaded), byte-equal to the golden encoder; and a
   bf16 input of 520 small chunks (stride 8) with an uncodeable cell (a
   non-sampled chunk holding an exponent byte no sampled chunk has: it
   must store raw) and a constant cell on the hopeless plane (RLE),
   byte-equal to the golden container; and bf16 and fp32 inputs of 530
   chunks of 256 B, encoded on the card byte-equal to the golden ones, and
   their per-chunk containers decoded on the card (short streams: K1 and
   K6 decode one stream per lane there);
4. three paths at full width, each decompressed by
   ``ZipNN(input_format="torch", engine="cuda")`` into a CUDA tensor that
   must equal the original, with the kernels' launches counted from 0 for
   that call:
   a. bf16, per-chunk tables: ``--mib`` MiB + 6002 bytes;
   b. fp32, per-chunk tables: ``--mib`` MiB + 6004 bytes;
   c. bf16, shared table (the sampled stride-8 table): ``--mib`` MiB +
      6002 bytes, which must launch ``huf_shared_decode`` and not
      ``huf_pc_decode``;
   all N(0, 0.05) from ``--seed``, compressed by the golden encoder
   (cached in ``zipnn_tpu_torch/_build/``); each path prints its plan,
   stage (host copies into pinned memory) and upload seconds of the first
   call (the staging pool may be cold) and of the second;
5. a flipped bit inside a Huffman stream, per-chunk and shared-table, must
   raise ``CorruptChunkError`` naming the plane and chunk the golden
   decoder names, and the stream;
6. the shared-table encode at full width, each container byte-equal to the
   golden encoder's (cached in ``_build/`` too), the launch counts set to 0
   just before the counted call and read just after:
   a. bf16 (``--mib`` MiB + 6002 bytes) from a CUDA tensor: must launch
      ``const_scan_rows`` and ``huf_shared_encode``, upload none of the
      input (only the tables and fetch indices, under 1/1000 of its size)
      and fetch less than the container plus 1 MiB (no host copy of the
      full chunks), and decode back bit-exact; then once from the host
      tensor;
   b. fp32 (``--mib`` MiB + 6004 bytes) from a CUDA tensor (4-plane split);
   c. bf16 again with a batch bound of half its size (256 MiB at the
      default ``--mib``, set through ``encode.batch_chunks``): at least
      two batches;
   and the default per-chunk encode at full width from a CUDA tensor,
   bf16 and fp32, each container byte-equal to phase 4's golden one: must
   launch ``hist_cells`` and ``huf_pc_encode`` and not ``const_scan_rows``
   or ``huf_shared_encode``, and upload none of the input;
7. a serving load at the published widths of Llama-3-8B
   (``meta-llama/Meta-Llama-3-8B`` ``config.json``: hidden 4096,
   intermediate 14336, 8 KV heads of 128), cut to 2 of its 32 decoder
   layers: 18 bf16 tensors (q, k, v, o, gate, up, down projections and two
   RMSNorm weights a layer, ~832 MiB), N(0, 0.05) from ``--seed`` made on
   the card and written by ``ZipNN(engine="cuda")`` in the per-chunk
   profile (k_proj's container byte-equal to the golden encoder's), decoded
   by ``io.serving.ShardDecoder(to_device=True)`` through
   ``decompress_iter``, ``decompress_all`` (first call, then staged
   ``stack_groups`` replayed twice through ``decompress_groups``) and by
   one ``ZipNN.decompress`` per container in a row; every output equal to
   its original; each way's wall, GB/s and summed plan, stage and upload
   seconds;
8. a checkpoint save of the same 18 tensors, from the card, in each
   profile (per-chunk, then shared): one ``ZipNN.compress`` per tensor,
   then ``io.serving.ShardEncoder.compress_iter`` with ``pool_staging``
   off and on (each container equal to the per-tensor one, k_proj's to
   the golden encoder's), must launch ``splice_cells`` and the profile's
   kernels; every container decoded back by ``ShardDecoder`` bit-exact;
   each way's wall, GB/s and summed plan, kernels, assemble, download and
   unstage seconds;
9. the whole-file streaming path: the load's 18 tensors laid out as one
   safetensors file in memory (the layout written here: no
   ``safetensors`` import), compressed by ``ZipNN(is_streaming=True,
   engine="cuda")`` in 1 MiB frames (~833, the last with no full chunk),
   byte-equal to engine ``"native"``'s, and decompressed on the card by
   ``ZipNN(is_streaming=True, engine="cuda")``: the bytes equal the file,
   parsing them gives the 18 tensors back, and ``huf_pc_decode`` launches
   fewer times than there are frames; the decode's wall, GB/s and frame
   walk, plan (its chunk tables' part and its CPU seconds), stage, upload
   and fetch seconds, and the full garbage collections inside it (and
   what one full collection of the process costs), beside the same bytes
   as one non-streaming container, and the encode's wall;
10. the per-tensor ``.znn.safetensors`` load: phase 7's containers written
    as one file under ``zipnn_tpu_torch/_build/`` with
    ``znn_compressed_vectors`` metadata, read back onto the card by
    ``io.streaming.SafetensorsStreamReader.load_shard`` (``ShardDecoder``
    inside, its launches counted), every tensor equal to its original;
    wall and GB/s beside phase 7's ``decompress_iter``;
11. delta: layer 0's ``q_proj`` as the base and the base plus N(0, 1e-3)
    from ``--seed`` in bf16 as the fine-tuned tensor; the byte-format delta
    container, plain and streaming, byte-equal between engines ``"cuda"``
    and ``"native"`` and decoded on the card back to the fine-tuned bytes;
12. lossy INTEGER: fp32 (64 MiB, N(0, 0.05), factor 27: the int32 path),
    bf16 (32 MiB, factor 8: the int16 path) and fp32 out of range (stored
    as floats), each encoded on the card from a CUDA tensor byte-equal to
    engine ``"native"``'s container, and decoded on the card (the
    int-to-float step too) to the tensor that engine ``"numpy"`` decodes;
13. the command-line tools and a trace on the card, in a temporary
    directory removed at the end whatever happens:
    a. phase 9's file written to disk, ``cli.compress_file.main([path,
       "--force"])`` (engine cuda, the default) must write engine
       ``"native"``'s container of phase 9 (SHA-256; each frame header's
       method byte is the CLI's ``--method HUFFMAN``) and launch
       ``hist_cells``, ``huf_pc_encode`` and ``splice_cells``;
       ``cli.decompress_file`` on the card must give the file back with
       fewer ``huf_pc_decode`` launches than frames; the same
       ``compress_file`` on ``--engine native``; and ``--huffman_table
       shared`` round-tripped (must launch ``const_scan_rows``,
       ``huf_shared_encode`` and ``splice_cells``; its frames each carry
       their own table, so the decode takes ``huf_pc_decode``); each wall
       with its file read and write apart; the path's kernels against
       their plain versions at its shapes (``hist_cells``,
       ``huf_pc_encode`` and ``splice_cells`` on one 1 MiB frame's batch,
       K1 and K2 on the first batch of the .znn's first run of frames);
    b. phase 11's q_proj pair as two files through
       ``cli.compress_file_delta`` (equal to ``--engine native``'s file)
       and ``cli.decompress_file_delta`` (the fine-tuned bytes back);
    c. ``cli.compress_path bin --max_processes 2`` and
       ``cli.decompress_path`` in spawned workers on the card over layer
       0's k, v and q projections as separate files: each .znn equal to the
       one ``compress_file`` writes, every file back, no ``ERROR`` line;
    d. ``stats.trace`` around one warm ``ZipNN(input_format="torch")``
       decompress of phase 4a's bf16 container and one warm compress of
       the same tensor: the trace must hold K1's and K2's kernels, then
       ``hist_cells``', ``huf_pc_encode``'s and ``splice_cells``', and the
       codec's ``znn:`` spans; each kernel's profiler times beside its
       phase-2 CUDA-event time, and the device's busy share of the traced
       window (kernels and copies, and kernels alone);
    e. ``stats.file_stats`` of a's .znn: 833 frames and the container's
       length.
    ``compress_safetensors`` and ``decompress_safetensors`` are not run:
    they need the ``safetensors`` package, which the card's host may not
    have (the CPU tests cover them).
14. several shards and several processes (``zipnn_tpu_torch.parallel``),
    printing each wall with its read and write and the phase's own:
    a. ``ZipNN(input_format="torch")`` compresses phase 4a's bf16 tensor
       (both profiles) and the fp32 one (per-chunk) and decompresses the
       golden containers onto the card, with no mesh, under
       ``make_mesh([dev, dev])`` (two shards on one card) and under
       ``make_mesh()``: each container equal to the golden one, each
       decode bit-exact, each kernel launched once a (batch, shard) range
       for each launch a batch makes with no mesh; K1 (bf16, fp32), K2
       (2 and 4 planes), K6, K8, K7, H, E and ``splice_cells`` (both
       profiles) held against their plain versions at the first shard of
       the 2-shard mesh's first batch;
    b. two processes started by ``spawn`` on the card, over gloo:
       ``compress_file_multihost`` of phase 9's file, per-chunk (the 10 %
       bounded check agreed through ``raw_planes``) and shared (a preset
       table from the summed sampled counts), each decompressed back by
       ``decompress_file_multihost``; the streaming mode on the file's
       first 64 MiB; ``compress_safetensors_multihost``, loaded back
       bit-exact by ``SafetensorsStreamReader``; each file equal to one
       process's, beside one process's engine native compress of the
       file; in a temporary directory removed at the end;
    c. ``entry.entry()``'s decode step (K1 then K2) and
       ``entry.dryrun_multichip(2)``.

Phase 3 also encodes, on the card from a CUDA tensor, the chunk sizes
whose planes are not whole words but hold 12 bytes or more (bf16 and
fp16 at 30 B, bf16 at 1002 B, fp32 at 52 and 100 B), both profiles: the
sub-word route with the host's cell encoders, equal to the golden
encoder, decoded on the card.

Each encode path prints its phase times (split, histogram, plan, kernels,
decide, assemble, splice, download, unstage) and end-to-end GB/s beside
the golden encoder's seconds.  It
prints a ``kernels`` JSON line (each kernel also with its launches in the
CLI's counted run of its path, ``cli_launches``, null where the CLI
runs another path; its time at the CLI's shapes, ``cli_ms`` and
``cli_bound_ms``; its time in phase 13's trace, ``profiler_ms``; its
launches in phase 14a's 2-shard run of its path, ``mesh_launches``, and
its time at one shard's shapes, ``mesh_ms`` and ``mesh_bound_ms``, null
where 14a does not run its path), the card's name and power limit and the
host CPU's model (the plan and splice are host timings), and as its last
line ``{"ok": true, "device": {...}}``.  Any failure raises, so
the exit code is not 0 and no result line is printed.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
TAIL_BF16 = 6002
TAIL_FP32 = 6004  # 1501 trailing floats: a short tail chunk
SMALL_MIB = 8  # the shared-table fixtures


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


def host_ms(fn):
    """(result, milliseconds) of one call, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, 1e3 * (time.perf_counter() - t0)


def gauss_f32(n: int, seed: int) -> np.ndarray:
    """n values of N(0, 0.05) as float32, made in 32 Mi-value steps."""
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=np.float32)
    step = 32 << 20
    for off in range(0, n, step):
        m = min(step, n - off)
        out[off : off + m] = rng.standard_normal(m) * 0.05
    return out


def synth(dtype: torch.dtype, nbytes: int, seed: int) -> torch.Tensor:
    """A CPU tensor of ``nbytes`` bytes of N(0, 0.05) in ``dtype`` (bf16 as
    the upper half of each float32)."""
    size = nbytes // torch.empty(0, dtype=dtype).element_size()
    vals = gauss_f32(size, seed)
    if dtype == torch.bfloat16:
        bits = (vals.view(np.uint32) >> 16).astype(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if dtype == torch.float16:
        return torch.from_numpy(vals.astype(np.float16))
    return torch.from_numpy(vals).to(dtype)


GOLDEN_S: dict = {}  # golden-encoder seconds of the containers made this run


def compressed(cache_dir: Path, tag: str, x: torch.Tensor, profile: str) -> bytes:
    """``x`` compressed by the golden encoder, cached in ``cache_dir``."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415

    cache = cache_dir / f"smoke_{tag}_{x.numel() * x.element_size()}_{profile}.znn"
    t0 = time.perf_counter()
    if cache.exists():
        comp = cache.read_bytes()
        how = f"read from {cache.name}"
    else:
        comp = bytes(ZipNN(input_format="torch", engine="numpy",
                           huffman_table=profile).compress(x))
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_bytes(comp)
        GOLDEN_S[(tag, profile)] = time.perf_counter() - t0
        how = f"compressed in {GOLDEN_S[(tag, profile)]:.1f} s"
    n = x.numel() * x.element_size()
    log(f"[{tag}] {n} bytes {x.dtype} ({profile}) -> {len(comp)} bytes "
        f"(ratio {len(comp) / n:.4f}), {how}")
    return comp


def plan_of(container: bytes, dev):
    """(plan, device inputs, first batch's full chunks) of a container."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.core import dtypes  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode  # noqa: PLC0415

    z = ZipNN(engine="cuda")
    after = z._retrieve_header(memoryview(container))
    plan = decode.build_plan(memoryview(container)[after:],
                             dtypes.groups_for_decompress(z.dtype), z._bit_reorder,
                             z._byte_reorder, z.compression_chunk, z.original_len)
    lo, hi = decode.plan_batches(plan.g.n_chunks, plan.g.chunk_size)[0]
    hi = min(hi, z.original_len // plan.g.chunk_size)  # full chunks only
    check(hi - lo >= 64, f"first batch has {hi - lo} full chunks, want >= 64")
    dv = decode.DeviceInputs(plan, dev)
    torch.cuda.current_stream(dev).wait_event(dv.upload(0))
    return plan, dv, (lo, hi)


def k1_table_bytes(k1a) -> int:
    """Bytes of the tables and per-stream table indices that K1 reads."""
    return 4 * (k1a[6].numel() + k1a[7].numel()) + 2 * k1a[8].numel()


def hold_decode(label, module, wrapper, plain, args, table_bytes):
    """A decode kernel against its plain version: bit-exact symbols and
    bits_left, every stream consumed exactly; its sync passes per stream
    (``module.last_sync_passes``), time and byte bound (``table_bytes``:
    the tables and per-stream table indices it reads)."""
    from zipnn_tpu_torch.ops import huf_sync  # noqa: PLC0415

    sym_k, bl_k = wrapper(*args)
    passes = module.last_sync_passes.cpu()
    check(int((passes < 0).sum()) == 0, f"{label}: a valid stream took the serial chain")
    (sym_p, bl_p), plain_ms = host_ms(lambda: plain(*args))
    err = int((sym_k.int() - sym_p.int()).abs().max())
    check(torch.equal(sym_k, sym_p) and torch.equal(bl_k, bl_p), f"{label} != plain")
    check(int(bl_k.abs().max()) == 0, f"{label}: streams not fully consumed")
    ms = cuda_ms(lambda: wrapper(*args))
    S = int(args[1].numel())
    # stream bytes, the per-stream arrays, the tables, symbols and bits_left
    nbytes = (int(args[2].sum()) + S * (8 + 4 + 4 + 8 + 4) + table_bytes
              + args[-1] + 4 * S)
    log(f"[kernels] {label}: {S} streams, {ms:.3f} ms (plain {plain_ms:.1f} ms), "
        f"bit-exact; sync passes per stream: {huf_sync.passes_summary(passes)}")
    return sym_k, {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                   "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                   "sync_passes_mean": float(passes.double().mean()),
                   "sync_passes_max": int(passes.max())}


def hold_combine(label, plan, k2a, original: torch.Tensor, lo, hi, offset: int = 0):
    """K2 against its plain version and the original bytes, writing into an
    ``out`` that starts ``offset`` bytes into its buffer."""
    from zipnn_tpu_torch.ops import combine, decode  # noqa: PLC0415

    total = k2a[6]
    n = -(-total // 4) * 4
    out_k = torch.empty(n + offset, dtype=torch.uint8, device="cuda")[offset:]
    out_p = torch.empty(n + offset, dtype=torch.uint8, device="cuda")[offset:]
    combine.combine_cells(*k2a, out_k)
    _, plain_ms = host_ms(lambda: combine.combine_cells_plain(*k2a, out_p))
    err = int((out_k.int() - out_p.int()).abs().max())
    check(torch.equal(out_k, out_p), f"{label} != plain")
    check(torch.equal(out_k[:total].cpu(), original.view(torch.uint8)[:total]),
          f"{label}: output != original")
    ms = cuda_ms(lambda: combine.combine_cells(*k2a, out_k))
    want = plan.g.want[:, lo:hi]
    kind = plan.g.kind[:, lo:hi]
    nbytes = (int(want[kind != decode.KIND_RLE].sum())
              + 12 * int(k2a[2].numel()) + out_k.numel())
    log(f"[kernels] {label}: {hi - lo} chunks of {plan.g.chunk_size} B, {ms:.3f} ms "
        f"(plain {plain_ms:.1f} ms), bit-exact")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def hold_combine_of(label, container: bytes, original: torch.Tensor, dev, offset: int = 0):
    """K2 on the first batch of a per-chunk container (its symbols from
    K1), held as ``hold_combine`` holds it."""
    from zipnn_tpu_torch.ops import huf_pc  # noqa: PLC0415

    plan, dv, (lo, hi) = plan_of(container, dev)
    sym, _ = huf_pc.huf_pc_decode(*dv.k1_args(lo, hi))
    return hold_combine(label, plan, dv.k2_args(lo, hi, sym), original, lo, hi, offset)


def drive(label, container, x_cpu, must_launch, must_not_launch, smi):
    """One path: decompress into a CUDA tensor with the launch counts set
    to 0 just before and read just after; a second call for its time."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode, kernels  # noqa: PLC0415

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x_cpu.element_size()]
    x_dev = x_cpu.to("cuda")
    nbytes = x_cpu.numel() * x_cpu.element_size()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = ZipNN(input_format="torch", engine="cuda").decompress(container)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    kms = decode.kernel_ms()
    timings = dict(decode.last_timings)
    check(y.is_cuda and y.dtype == x_cpu.dtype and y.shape == x_cpu.shape,
          f"{label} gave {y.device} {y.dtype} {tuple(y.shape)}")
    check(torch.equal(y.view(ints), x_dev.view(ints)), f"{label} mismatch")
    for k in must_launch:
        check(launches[k] > 0, f"kernel {k} not launched on the {label} path")
    for k in must_not_launch:
        check(launches[k] == 0, f"kernel {k} launched on the {label} path")
    del y
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = ZipNN(input_format="torch", engine="cuda").decompress(container)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    t2 = dict(decode.last_timings)
    check(torch.equal(y.view(ints), x_dev.view(ints)), f"second {label} run mismatch")
    del y, x_dev
    ktxt = ", ".join(f"{k} {v:.3f} ms" for k, v in kms.items())

    def phases(t):
        return (f"plan {t['plan_s']:.4f} s, stage {t['stage_s']:.4f} s, "
                f"upload {t['upload_s']:.4f} s")

    log(f"[{label}] {nbytes} bytes {x_cpu.dtype} -> CUDA tensor, bit-exact; "
        f"{phases(timings)}, {ktxt}, end to end {wall:.4f} s = {nbytes / wall / 1e9:.3f} GB/s "
        f"(second run: {phases(t2)}, {wall2:.4f} s = {nbytes / wall2 / 1e9:.3f} GB/s); "
        f"launches {launches}; card: {smi}")
    return launches


def corrupt_case(label, comp: bytes, stream: int):
    """Flip bits of one stream until the golden decoder rejects the
    container; the CUDA engine must name the same plane and chunk, and the
    stream."""
    from zipnn_tpu_torch import CorruptChunkError, ZipNN, codec  # noqa: PLC0415
    from zipnn_tpu_torch.core import dtypes  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode  # noqa: PLC0415

    z = ZipNN(engine="cuda")
    after = z._retrieve_header(memoryview(comp))
    geo = (dtypes.groups_for_decompress(z.dtype), z._bit_reorder, z._byte_reorder,
           z.compression_chunk, z.original_len)
    plan = decode.build_plan(memoryview(comp)[after:], *geo)
    s0 = after + int(plan.starts[stream])
    ln = int(plan.lens[stream])
    exp = None
    for bit in range(8 * (ln // 2), 8 * ln - 8):
        bad = bytearray(comp)
        bad[s0 + bit // 8] ^= 1 << (bit % 8)
        try:
            codec.decompress_payload_numpy(memoryview(bytes(bad))[after:], *geo)
        except CorruptChunkError as e:
            exp = (bytes(bad), e.plane, e.chunk)
            break
    check(exp is not None, f"{label}: no bit flip found that the golden decoder rejects")
    try:
        ZipNN(engine="cuda").decompress(exp[0])
    except CorruptChunkError as e:
        want = (exp[1], exp[2], stream % 4)
        check((e.plane, e.chunk, e.stream) == want, (label, e, want))
        log(f"[corrupt] {label}: bit flip in stream {stream} -> {e} "
            f"(decoder {decode.last_timings['decoder']})")
        return decode.last_timings["decoder"]
    raise RuntimeError(f"chip_smoke check failed: corrupt {label} container decoded")


def first_shard(lo: int, hi: int, parts: int):
    """The first of ``parts`` shards of chunks [lo, hi), as a mesh of
    ``parts`` entries splits them (``parallel.sharded.chunk_range``)."""
    from zipnn_tpu_torch.parallel.sharded import chunk_range  # noqa: PLC0415

    a, b = chunk_range(0, parts, hi - lo)
    return lo + a, lo + b


def encode_first_batch(x_cpu: torch.Tensor, dev, chunk: int = 256 * 1024, parts: int = 1):
    """A shared encode path's first batch on the card (the first of its
    ``parts`` shards): its split planes [k, num_buf, W], the live planes'
    K7 tables (from the sampled counts), and the batch's geometry."""
    from zipnn_tpu_torch import codec  # noqa: PLC0415
    from zipnn_tpu_torch.core import dtypes  # noqa: PLC0415
    from zipnn_tpu_torch.ops import byte_group, encode, huf_enc, transforms  # noqa: PLC0415

    gr = dtypes.grouping_for_code(dtypes.from_any(x_cpu.dtype).code)
    flat = x_cpu.view(torch.uint8).reshape(-1).numpy()
    g = encode.Geometry(flat.size, gr.num_buf, chunk)
    src = encode.Source(flat, g, dev)
    tail = byte_group.split(src.tail, gr.num_buf, gr.byte_reorder, gr.bit_reorder)
    counts = sum(src.get(c) for c in encode.sampled_counts(src, g, gr.byte_reorder,
                                                           gr.bit_reorder))
    if g.full % g.stride == 0:  # the tail cell is on stride: sampled too
        for b, plane in enumerate(tail):
            counts[b] += np.bincount(plane, minlength=256)
    shared, live = codec.shared_tables_from_counts(counts, codec.DEFAULT_THRESHOLD, g.stride)
    lo, hi = first_shard(*g.batches[0], parts)
    check(hi - lo >= 64, f"first encode batch has {hi - lo} chunks, want >= 64")
    planes = transforms.split_device(src.batch(lo, hi, dev), gr.num_buf, gr.byte_reorder,
                                     gr.bit_reorder)
    tables = {b: torch.from_numpy(huf_enc.pack_etable(shared[b][1], shared[b][0])).to(dev)
              for b in range(gr.num_buf) if live[b]}
    return g, planes, tables


def hold_huf_encode(g, planes, tables, dev):
    """K7 against its plain version over every stream of each live plane
    of a split batch: bit-exact ``total_bits`` and stream bytes; its time
    (summed over the planes) and byte bound."""
    from zipnn_tpu_torch.ops import huf_enc  # noqa: PLC0415

    k, nb, w = planes.shape
    check(len(tables) > 0, "no live plane on the shared encode path")
    cells = torch.arange(k, dtype=torch.int64, device=dev)[:, None] * nb
    quarter = torch.arange(4, dtype=torch.int64, device=dev) * (w // 4)
    ms7 = plain7 = 0.0
    nbytes7 = 0
    n_streams = 0
    for b, table in tables.items():
        streams = ((cells + b) * w + quarter).reshape(-1)
        r_k, t_k = huf_enc.huf_shared_encode(planes, table, g.seg, streams)
        (r_p, t_p), pms = host_ms(
            lambda: huf_enc.huf_shared_encode_plain(planes, table, g.seg, streams))
        check(torch.equal(t_k, t_p), f"huf_shared_encode total_bits != plain (plane {b})")
        sb = ((t_p & 0x3FFFFFFF) + 7) // 8
        width = int(sb.max())
        keep = torch.arange(width, device=dev) < sb[:, None]
        bk = r_k.view(torch.uint8)[:, :width]
        bp = r_p.view(torch.uint8)[:, :width]
        check(torch.equal(bk[keep], bp[keep]), f"huf_shared_encode bytes != plain (plane {b})")
        del r_p, bp, keep
        ms7 += cuda_ms(lambda: huf_enc.huf_shared_encode(planes, table, g.seg, streams))
        plain7 += pms
        S = int(streams.numel())
        n_streams += S
        # symbols read, stream bytes written, table, offsets, total_bits
        nbytes7 += S * g.seg + int(sb.sum()) + 512 + 8 * S + 4 * S
        log(f"[kernels] huf_shared_encode (plane {b}: {S} streams of {g.seg} symbols, "
            f"{int((t_k >> 30).sum())} with an uncoded byte): bit-exact on every "
            f"stream's bytes and total_bits")
    log(f"[kernels] huf_shared_encode: {ms7:.3f} ms (plain {plain7:.1f} ms) over "
        f"{n_streams} streams")
    return {"ms": ms7, "plain_ms": plain7, "max_abs_err": 0,
            "bound_ms": 1e3 * nbytes7 / HBM_BYTES_PER_S}


def hold_encode_kernels(x_cpu: torch.Tensor, dev, parts: int = 1):
    """K8 and K7 against their plain versions at the bf16 shared encode
    path's first batch (the first of its ``parts`` shards): K8 over every
    (chunk, plane) row, K7 over every stream of each live plane; bit-exact
    flags, ``total_bits`` and stream bytes; their times and byte bounds."""
    from zipnn_tpu_torch.ops import const_scan  # noqa: PLC0415

    g, planes, tables = encode_first_batch(x_cpu, dev, parts=parts)
    k, nb, w = planes.shape
    rows = planes.view(k * nb, w)
    f_k = const_scan.const_scan_rows(rows)
    f_p, plain8 = host_ms(lambda: const_scan.const_scan_rows_plain(rows))
    check(torch.equal(f_k, f_p), "const_scan_rows != plain")
    ms8 = cuda_ms(lambda: const_scan.const_scan_rows(rows))
    n_const = int((f_k >> 8).sum())
    log(f"[kernels] const_scan_rows ({k} chunks, {k * nb} rows of {4 * w} bytes): "
        f"{ms8:.3f} ms (plain {plain8:.1f} ms), {n_const} constant rows, bit-exact")
    k8 = {"ms": ms8, "plain_ms": plain8, "max_abs_err": 0,
          "bound_ms": 1e3 * (rows.numel() * 4 + 4 * k * nb) / HBM_BYTES_PER_S}
    return k8, hold_huf_encode(g, planes, tables, dev)


def hold_pc_encode_kernels(x_cpu: torch.Tensor, dev, chunk: int = 256 * 1024,
                           min_chunks: int = 64, parts: int = 1):
    """``hist_cells`` and ``huf_pc_encode`` against their plain versions at
    a per-chunk encode path's first batch (the first of its ``parts``
    shards), with the host plan of its cells
    between them (``encode.plan_cells``): bit-exact counts, stream bytes
    and ``total_bits``; their times, byte bounds, and for the histogram the
    one PyTorch call that computes it (``torch.bincount`` over
    ``cell * 256 + byte``, its index built outside the timing).  Returns
    the two kernels' numbers and the batch's inputs to them (``rows``,
    ``planes``, ``tables``, ``streams``, ``seg``)."""
    from zipnn_tpu_torch.core import dtypes  # noqa: PLC0415
    from zipnn_tpu_torch.ops import encode, hist, huf_enc, transforms  # noqa: PLC0415

    gr = dtypes.grouping_for_code(dtypes.from_any(x_cpu.dtype).code)
    nb = gr.num_buf
    x_dev = x_cpu.to(dev).view(torch.uint8).reshape(-1)
    g = encode.Geometry(x_dev.numel(), nb, chunk, shared=False)
    lo, hi = first_shard(*g.batches[0], parts)
    k, pw = hi - lo, g.plane_bytes // 4
    check(k >= min_chunks, f"first per-chunk encode batch has {k} chunks, want >= {min_chunks}")
    planes = transforms.split_device(encode.Source(x_dev, g, dev).batch(lo, hi, dev), nb,
                                     gr.byte_reorder, gr.bit_reorder)
    rows = planes.view(k * nb, pw)
    h_k = hist.hist_cells(rows)
    h_p, plain_h = host_ms(lambda: hist.hist_cells_plain(rows))
    check(torch.equal(h_k, h_p), "hist_cells != plain")
    del h_p
    ms_h = cuda_ms(lambda: hist.hist_cells(rows))
    idx = hist.cell_byte_index(rows).reshape(-1)
    lib_h = cuda_ms(lambda: torch.bincount(idx, minlength=k * nb * 256))
    del idx
    log(f"[kernels] hist_cells ({k * nb} cells of {g.plane_bytes} B): {ms_h:.3f} ms "
        f"(plain {plain_h:.1f} ms, torch.bincount {lib_h:.3f} ms), bit-exact")
    hk = {"ms": ms_h, "plain_ms": plain_h, "max_abs_err": 0, "library_ms": lib_h,
          "bound_ms": 1e3 * (rows.numel() * 4 + h_k.numel() * 4) / HBM_BYTES_PER_S}
    t0 = time.perf_counter()
    plan = encode.plan_cells(h_k.cpu().numpy().reshape(k, nb, 256).astype(np.int64),
                             g.plane_bytes, np.zeros(nb, dtype=bool))
    plan_s = time.perf_counter() - t0
    log(f"[kernels] host plan of {k * nb} cells: {int(plan.rle.sum())} RLE, "
        f"{plan.cand.size} Huffman tables built in {plan_s:.3f} s")
    check(plan.cand.size > 0, "no Huffman cell in the per-chunk batch")
    tables = torch.from_numpy(plan.tables).to(dev)
    quarter = torch.arange(4, dtype=torch.int64, device=dev) * (pw // 4)
    streams = (torch.from_numpy(plan.cand).to(dev)[:, None] * pw + quarter).reshape(-1)
    r_k, t_k = huf_enc.huf_pc_encode(planes, tables, g.seg, streams)
    (r_p, t_p), plain7 = host_ms(
        lambda: huf_enc.huf_pc_encode_plain(planes, tables, g.seg, streams))
    check(torch.equal(t_k, t_p), "huf_pc_encode total_bits != plain")
    sb = ((t_p & 0x3FFFFFFF) + 7) // 8
    width = int(sb.max())
    keep = torch.arange(width, device=dev) < sb[:, None]
    check(torch.equal(r_k.view(torch.uint8)[:, :width][keep],
                      r_p.view(torch.uint8)[:, :width][keep]), "huf_pc_encode bytes != plain")
    del r_p, keep
    ms7 = cuda_ms(lambda: huf_enc.huf_pc_encode(planes, tables, g.seg, streams))
    S = int(streams.numel())
    tl = int(np.max(plan.tables.view(np.uint16) >> 12))
    log(f"[kernels] huf_pc_encode ({S} streams of {g.seg} symbols, {plan.cand.size} "
        f"tables, codes up to {tl} bits): {ms7:.3f} ms (plain {plain7:.1f} ms), bit-exact "
        f"on every stream's bytes and total_bits")
    # symbols read, stream bytes written, tables, offsets, total_bits
    nbytes7 = S * g.seg + int(sb.sum()) + tables.numel() * 2 + 8 * S + 4 * S
    k7 = {"ms": ms7, "plain_ms": plain7, "max_abs_err": 0,
          "bound_ms": 1e3 * nbytes7 / HBM_BYTES_PER_S}
    return hk, k7, {"rows": rows, "planes": planes, "tables": tables,
                    "streams": streams, "seg": g.seg,
                    "counts": h_k.cpu().numpy().reshape(k, nb, 256), "n": g.plane_bytes}


def hold_native(batch: dict, container: bytes) -> None:
    """The native host core against the plain Python it replaces, on the
    bf16 per-chunk paths: ``native.build_ctables`` against
    ``encode.cell_table`` on every cell of the encode's first batch that
    passes the cheap checks (status, header bytes, packed entries); the
    native weight-header parse (``huf_pc.distinct_tables``) against the Python
    one on every Huffman cell of ``container``.  Each timed on the host.
    (The native splice is held against ``splice_cells`` in
    :func:`hold_splice`.)"""
    from zipnn_tpu_torch import ZipNN, native  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode, encode, huf_enc, huf_pc  # noqa: PLC0415

    counts, n = batch["counts"], batch["n"]
    flat = counts.reshape(-1, 256)
    largest = flat.max(axis=1)
    coded = flat[(largest < n) & (largest > (n >> 7) + 4)]
    got, nat_ms = host_ms(lambda: native.build_ctables(coded, n))
    status, lengths, vals, headers, hlens = got
    want, plain_ms = host_ms(lambda: [encode.cell_table(c, n) for c in coded])
    for i, w in enumerate(want):
        check(bool(status[i]) == (w is not None), f"build_ctables status, cell {i}")
        if w is not None:
            check(bytes(headers[i, : hlens[i]]) == w[0], f"build_ctables header, cell {i}")
            check(np.array_equal(huf_enc.pack_pc_table(vals[i], lengths[i]), w[1]),
                  f"build_ctables table, cell {i}")
    log(f"[native] build_ctables: {coded.shape[0]} cells of {n} B ({int(status.sum())} "
        f"Huffman) in {nat_ms:.2f} ms, cell_table (Python) {plain_ms:.1f} ms: equal")

    seen = []
    parse = huf_pc.distinct_tables

    def spy(hdrs):
        seen.append(list(hdrs))
        return parse(hdrs)

    z = ZipNN(engine="cuda")
    after = z._retrieve_header(memoryview(container))
    huf_pc.distinct_tables = spy
    try:
        decode.build_plan(memoryview(container)[after:], 2, z._bit_reorder, z._byte_reorder,
                          z.compression_chunk, z.original_len)
    finally:
        huf_pc.distinct_tables = parse
    hdrs = seen[0]
    got, nat_ms = host_ms(lambda: huf_pc.distinct_tables(hdrs))
    want, plain_ms = host_ms(lambda: huf_pc.distinct_tables_plain(hdrs))
    check(got[3] == want[3] and all(np.array_equal(a, b) for a, b in zip(got[:3], want[:3])),
          "native header parse != Python")
    log(f"[native] header parse: {len(hdrs)} weight headers ({len(set(hdrs))} distinct) in "
        f"{nat_ms:.2f} ms, Python {plain_ms:.1f} ms: equal tables")


def hold_splice(x_cpu: torch.Tensor, wants: dict, dev) -> dict:
    """``splice_cells`` against its plain version on the card and against
    the native core's splice on the host, on the cells of the first batch
    of the encode of ``x_cpu`` from the card in each profile of ``wants``
    (profile: golden container, which the encode must equal): bit-exact;
    the kernel's time (CUDA events around its launch, median of 3 after
    one warm-up) and byte bound (the stored bytes read and written, and
    the cell descriptors)."""
    from zipnn_tpu_torch import ZipNN, native  # noqa: PLC0415
    from zipnn_tpu_torch.ops import kernels, splice  # noqa: PLC0415

    x_dev = x_cpu.to(dev)
    out_rows = {}
    for profile, want in wants.items():
        captured = []
        card = splice.splice_cells

        def keep(out, cells, groups, hpool, _card=card):
            _card(out, cells, groups, hpool)
            captured.append((out, cells, groups, hpool))

        splice.splice_cells = keep
        try:
            got = ZipNN(input_format="torch", engine="cuda", huffman_table=profile,
                        device=dev).compress(x_dev)
        finally:
            splice.splice_cells = card
        check(bytes(got) == want, f"{profile} encode with the captured splice != golden")
        del got
        out, cells, groups, hpool = captured[0]
        del captured
        plain = torch.empty_like(out)
        _, plain_ms = host_ms(lambda: splice.splice_cells_plain(plain, cells, groups, hpool))
        check(torch.equal(out, plain), f"splice_cells ({profile}) != plain")
        del plain
        host = splice.host_cells(cells, groups, hpool)
        again = np.zeros(out.numel(), np.uint8)
        _, nat_ms = host_ms(lambda: native.splice_cells(again, **host))
        check(np.array_equal(again, out.cpu().numpy()), f"splice_cells ({profile}) != native")
        del host, again
        buf = torch.empty_like(out)
        with kernels.recording() as events:
            for _ in range(4):
                splice.splice_cells(buf, cells, groups, hpool)
        ms = float(np.median([kernels.elapsed_ms([e])["splice_cells"] for e in events[1:]]))
        check(torch.equal(buf, out), f"splice_cells ({profile}) not repeatable")
        kinds = np.bincount((cells[:, splice.INFO] >> 32) & 0xFF, minlength=3)
        nbytes = 2 * out.numel() + cells.nbytes + 16 * len(groups)
        log(f"[kernels] splice_cells ({profile}, {cells.shape[0]} cells: {kinds[0]} raw, "
            f"{kinds[1]} RLE, {kinds[2]} Huffman; {out.numel()} bytes): {ms:.3f} ms (plain "
            f"{plain_ms:.1f} ms), bit-exact; the native splice of the same cells {nat_ms:.1f} ms, "
            f"equal")
        out_rows[profile] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0,
                             "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
        del out, cells, groups, hpool, buf
        torch.cuda.empty_cache()
    return out_rows


def encode_small(x: torch.Tensor, want: bytes, label: str, **kw) -> None:
    """An encode on the card (shared profile unless ``huffman_table``
    says otherwise) from the host tensor and from a CUDA tensor: both
    byte-equal to ``want``, decoded back bit-exact."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import encode  # noqa: PLC0415

    kw.setdefault("huffman_table", "shared")
    encoder = "huf_shared_encode" if kw["huffman_table"] == "shared" else "huf_pc_encode"
    z = ZipNN(input_format="torch", engine="cuda", **kw)
    for src in (x, x.to("cuda")):
        got = bytes(z.compress(src))
        check(encode.last_timings["encoder"] == encoder, f"{label}: encoder")
        check(got == want, f"{label}: card container != golden ({src.device})")
    y = ZipNN(input_format="torch", engine="cuda").decompress(got)
    check(torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8)),
          f"{label}: card container does not decode back")


def uncodeable_case(seed: int) -> None:
    """bf16, 520 chunks of 4 KB (stride 8) + a tail: chunk 9 (not sampled)
    holds an exponent byte that no sampled chunk has, chunk 13's mantissa
    plane is constant.  The card's container must equal the golden one,
    with cell (exponent, 9) raw and cell (mantissa, 13) RLE."""
    from zipnn_tpu_torch import ZipNN, codec  # noqa: PLC0415

    chunk = 4096
    x = synth(torch.bfloat16, 520 * chunk + 998, seed)
    v = x.view(torch.int16).numpy()
    per = chunk // 2
    v[9 * per + 100] = 0x7000  # exponent byte 0xE0 after the sign rotation
    v[13 * per : 14 * per] = (np.arange(per) % 64) << 7  # mantissa bytes all 0
    want = bytes(ZipNN(input_format="torch", engine="numpy", huffman_table="shared",
                       compression_chunk=chunk).compress(x))
    encode_small(x, want, "uncodeable", compression_chunk=chunk)
    after = ZipNN(engine="numpy")._retrieve_header(memoryview(want))
    types, starts, _ = codec.parse_tables(memoryview(want)[after:], 2, 521)
    sizes = np.diff(starts, axis=1)
    check(types[1, 9] == 0 and sizes[1, 9] == chunk // 2, "uncodeable cell not raw")
    check(types[1, 8] == 1 and types[1, 10] == 1, "its neighbours are not Huffman")
    check(types[0, 13] == 1 and sizes[0, 13] == 1, "constant hopeless cell not RLE")
    check(not types[0, :13].any(), "the mantissa plane is not hopeless")
    log(f"[encode] uncodeable: 520 x {chunk} B + 998 B bf16 (stride 8), card == golden; "
        f"cell (1, 9) raw, cell (0, 13) RLE")


def small_chunk_case(seed: int) -> None:
    """Chunks below 512 bytes encode on the card too: bf16 and fp32, 530
    chunks of 256 B (stride 8) + a tail, byte-equal to the golden
    encoder.  The golden per-chunk containers of the same inputs decode
    on the card bit-exact: short streams, so K1 takes a lane per stream."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode  # noqa: PLC0415

    chunk = 256
    for i, dt in enumerate((torch.bfloat16, torch.float32)):
        x = synth(dt, 530 * chunk + 36, seed + i)
        want = bytes(ZipNN(input_format="torch", engine="numpy", huffman_table="shared",
                           compression_chunk=chunk).compress(x))
        encode_small(x, want, f"{dt} at {chunk} B chunks", compression_chunk=chunk)
        per_chunk = ZipNN(input_format="torch", engine="numpy",
                          compression_chunk=chunk).compress(x)
        y = ZipNN(input_format="torch", engine="cuda").decompress(per_chunk)
        check(decode.last_timings["decoder"] == "huf_pc_decode", f"{dt} per-chunk decoder")
        check(torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8)),
              f"{dt} per-chunk container at {chunk} B chunks")
        log(f"[encode] {dt}: 530 x {chunk} B + 36 B (stride 8), card == golden; "
            f"the per-chunk container decodes on the card bit-exact")


def sub_word_case(seed: int) -> None:
    """Chunks of 1 and 2 bytes: every dtype's container in both profiles
    (the golden encoder's) decodes on the card bit-exact, ``combine_cells``
    filling them byte by byte; and the encode of every chunk size whose
    planes are under one word (bf16 and fp16 up to 4 bytes, fp32 up to 8,
    fp8 up to 2), both profiles, runs on the card from a CUDA tensor (the
    sub-word route, none of the input uploaded), byte-equal to the golden
    encoder."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import encode, kernels  # noqa: PLC0415

    for i, (dt, top) in enumerate(((torch.bfloat16, 4), (torch.float16, 4),
                                   (torch.float32, 8), (torch.float8_e4m3fn, 2))):
        x = synth(dt, 1200, seed + i)
        for chunk in (c for c in (1, 2, 4, 8) if c <= top):
            for profile in ("per_chunk", "shared"):
                want = bytes(ZipNN(input_format="torch", engine="numpy", compression_chunk=chunk,
                                   huffman_table=profile).compress(x))
                if chunk <= 2:
                    kernels.reset_launches()
                    y = ZipNN(input_format="torch", engine="cuda").decompress(want)
                    check(kernels.launches["combine_cells"] > 0, f"{dt} {chunk} B: no K2")
                    check(torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8)),
                          f"{dt} at {chunk} B chunks ({profile}) decoded on the card")
                got = bytes(ZipNN(input_format="torch", engine="cuda", compression_chunk=chunk,
                                  huffman_table=profile).compress(x.to("cuda")))
                t = encode.last_timings
                check(t["encoder"] == "sub_word", f"{dt} {chunk} B encoder {t['encoder']}")
                check(t["upload_bytes"] == 0, f"{dt} {chunk} B: {t['upload_bytes']} bytes uploaded")
                check(got == want, f"{dt} {profile} encode at {chunk} B chunks != golden")
        log(f"[sub-word] {dt}: chunks of 1 and 2 B decoded on the card (both profiles); "
            f"encode at chunks up to {top} B on the card (sub-word route, nothing uploaded), "
            f"both profiles == golden")
    # planes that are not whole words but hold 12 bytes or more: the
    # sub-word route with the host's cell encoders (each payload against
    # the golden encoder's, then decoded on the card)
    from zipnn_tpu_torch import codec  # noqa: PLC0415

    for i, (dt, chunk) in enumerate(((torch.bfloat16, 30), (torch.bfloat16, 1002),
                                     (torch.float32, 52), (torch.float32, 100),
                                     (torch.float16, 30))):
        raw = synth(dt, 520 * chunk + 6, seed + 10 + i).view(torch.uint8).numpy().copy()
        raw[3 * chunk : 9 * chunk] = 0x3C  # RLE cells
        nb, br = (4, 220) if dt == torch.float32 else (2, 10)
        for shared in (False, True):
            t0 = time.perf_counter()
            got = codec.compress_payload(torch.from_numpy(raw).cuda(), nb, 1, br, chunk,
                                         engine="cuda", device="cuda", shared_tables=shared,
                                         check_th_after_percent=10)
            ms = 1e3 * (time.perf_counter() - t0)
            t = encode.last_timings
            check(t["encoder"] == "sub_word_host", f"{dt} {chunk} B encoder {t['encoder']}")
            check(t["upload_bytes"] == 0, f"{dt} {chunk} B: {t['upload_bytes']} bytes uploaded")
            check(bytes(got) == codec.compress_payload_numpy(
                raw, nb, 1, br, chunk, check_th_after_percent=10, shared_tables=shared),
                f"{dt} {chunk} B (shared {shared}) != golden")
            back = codec.decompress_payload(bytes(got), nb, 1, br, chunk, raw.size,
                                            engine="cuda", device="cuda")
            check(np.array_equal(back.cpu().numpy(), raw), f"{dt} {chunk} B: decode on the card")
            log(f"[sub-word] {dt} at {chunk} B chunks (planes {raw.size // chunk} x "
                f"{chunk // nb}+ B, shared {shared}): encoded from a CUDA tensor by the "
                f"sub-word route with host cell encoders in {ms:.1f} ms, == golden, decoded "
                f"on the card")


def host_phases(t: dict, kms: dict) -> str:
    """The encode's phases after its kernels (``encode.last_timings``)."""
    return (f"decide {t['decide_s']:.4f} s, assemble {t['assemble_s']:.4f} s (splice_cells "
            f"{kms['splice_cells']:.3f} ms), splice {t['splice_s']:.4f} s, download "
            f"{t['download_s']:.4f} s, unstage {t['unstage_s']:.4f} s ({t['d2h_bytes']} bytes "
            f"down, {t['h2d_bytes']} bytes of tables, indices and cells up)")


def encode_path(label, x_cpu, want: bytes, golden_s, smi):
    """One full-width shared encode from a CUDA tensor, with the launch
    counts set to 0 just before the call and read just after: byte-equal
    to ``want``, K8 and K7 launched, none of the input uploaded (the
    tables and fetch indices under 1/1000 of its size), and less fetched
    than the container plus 1 MiB.  A second call for its time.  Returns
    (the CUDA tensor, the launches, the container)."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import encode, kernels  # noqa: PLC0415

    nbytes = x_cpu.numel() * x_cpu.element_size()
    x_dev = x_cpu.to("cuda")
    z = ZipNN(input_format="torch", engine="cuda", huffman_table="shared")
    kernels.reset_launches()
    got, ms = host_ms(lambda: z.compress(x_dev))
    launches = dict(kernels.launches)
    t = dict(encode.last_timings)
    kms = encode.kernel_ms()
    check(bytes(got) == want, f"{label}: card container != golden")
    check(t["upload_bytes"] == 0,
          f"{label}: {t['upload_bytes']} input bytes uploaded from a CUDA tensor")
    check(t["h2d_bytes"] < nbytes // 1000,
          f"{label}: {t['h2d_bytes']} bytes of tables and indices uploaded")
    check(t["d2h_bytes"] <= len(want) + (1 << 20),
          f"{label}: fetched {t['d2h_bytes']} bytes for a {len(want)}-byte container")
    for k in ("const_scan_rows", "huf_shared_encode", "splice_cells"):
        check(launches[k] > 0, f"kernel {k} not launched on the {label} path")
    _, ms2 = host_ms(lambda: z.compress(x_dev))
    gs = "cached" if golden_s is None else f"{golden_s:.1f} s"
    log(f"[encode] {label}: {nbytes} bytes {x_cpu.dtype} from a CUDA tensor -> "
        f"{len(want)} bytes == golden; {t['batches']} batches; hist {t['hist_s']:.3f} s, "
        f"split {t['split_s']:.3f} s, const_scan_rows {kms['const_scan_rows']:.3f} ms, "
        f"huf_shared_encode {kms['huf_shared_encode']:.3f} ms, kernels {t['kernels_s']:.3f} s, "
        f"{host_phases(t, kms)}; "
        f"end to end {ms / 1e3:.3f} s = {nbytes / ms / 1e6:.3f} GB/s (second run "
        f"{ms2 / 1e3:.3f} s = {nbytes / ms2 / 1e6:.3f} GB/s); golden encoder {gs}; "
        f"launches {launches}; card: {smi}")
    return x_dev, launches, got


def pc_encode_path(label, x_cpu, want: bytes, golden_s, smi):
    """The default per-chunk encode at full width from a CUDA tensor, the
    launch counts set to 0 just before the call and read just after:
    byte-equal to ``want``, ``hist_cells`` and ``huf_pc_encode`` launched
    and neither shared-profile kernel, none of the input uploaded (only the
    tables and indices, under 1/100 of its size) and less fetched than the
    container, the cell counts and 1 MiB.  A second call for its time.
    Returns the launches."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import encode, kernels  # noqa: PLC0415

    nbytes = x_cpu.numel() * x_cpu.element_size()
    x_dev = x_cpu.to("cuda")
    z = ZipNN(input_format="torch", engine="cuda")
    kernels.reset_launches()
    got, ms = host_ms(lambda: z.compress(x_dev))
    launches = dict(kernels.launches)
    t = dict(encode.last_timings)
    kms = encode.kernel_ms()
    check(t["encoder"] == "huf_pc_encode", f"{label}: encoder {t['encoder']}")
    check(bytes(got) == want, f"{label}: card container != golden")
    check(t["upload_bytes"] == 0,
          f"{label}: {t['upload_bytes']} input bytes uploaded from a CUDA tensor")
    check(t["h2d_bytes"] < nbytes // 100,
          f"{label}: {t['h2d_bytes']} bytes of tables and indices uploaded")
    cells = 1024 * (nbytes // (256 * 1024)) * 4
    check(t["d2h_bytes"] <= len(want) + cells + (1 << 20),
          f"{label}: fetched {t['d2h_bytes']} bytes for a {len(want)}-byte container")
    for k in ("hist_cells", "huf_pc_encode", "splice_cells"):
        check(launches[k] > 0, f"kernel {k} not launched on the {label} path")
    for k in ("const_scan_rows", "huf_shared_encode"):
        check(launches[k] == 0, f"kernel {k} launched on the {label} path")
    _, ms2 = host_ms(lambda: z.compress(x_dev))
    gs = "cached" if golden_s is None else f"{golden_s:.1f} s"
    log(f"[encode] {label}: {nbytes} bytes {x_cpu.dtype} from a CUDA tensor -> "
        f"{len(want)} bytes == golden; {t['batches']} batches; split {t['split_s']:.3f} s, "
        f"hist {t['hist_s']:.3f} s (hist_cells {kms['hist_cells']:.3f} ms), plan "
        f"{t['plan_s']:.3f} s, kernels {t['kernels_s']:.3f} s (huf_pc_encode "
        f"{kms['huf_pc_encode']:.3f} ms), {host_phases(t, kms)}; "
        f"end to end {ms / 1e3:.3f} s = {nbytes / ms / 1e6:.3f} GB/s (second run "
        f"{ms2 / 1e3:.3f} s = {nbytes / ms2 / 1e6:.3f} GB/s); golden encoder {gs}; "
        f"launches {launches}; card: {smi}")
    return launches


# Llama-3-8B (meta-llama/Meta-Llama-3-8B, config.json): hidden_size 4096,
# intermediate_size 14336, 32 heads, 8 KV heads, head_dim 128; 2 of its 32
# decoder layers
LLAMA3_8B = {"hidden": 4096, "intermediate": 14336, "kv": 8 * 128, "layers": 2}


def llama_tensors(cfg=LLAMA3_8B):
    """(name, shape) of the bf16 weights of the first ``layers`` decoder
    layers, as the checkpoint stores them (``nn.Linear`` weights are [out,
    in]): 9 a layer, the two RMSNorm weights with no full 256 KB chunk."""
    h, i, kv = cfg["hidden"], cfg["intermediate"], cfg["kv"]
    out = []
    for layer in range(cfg["layers"]):
        p = f"model.layers.{layer}."
        out += [(p + "self_attn.q_proj.weight", (h, h)), (p + "self_attn.k_proj.weight", (kv, h)),
                (p + "self_attn.v_proj.weight", (kv, h)), (p + "self_attn.o_proj.weight", (h, h)),
                (p + "mlp.gate_proj.weight", (i, h)), (p + "mlp.up_proj.weight", (i, h)),
                (p + "mlp.down_proj.weight", (h, i)), (p + "input_layernorm.weight", (h,)),
                (p + "post_attention_layernorm.weight", (h,))]
    return out


def llama_tensors_on_card(seed: int, dev):
    """(names, tensors): the load's tensors, N(0, 0.05) in bf16 from
    ``seed``, made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    names, xs = [], []
    for name, shape in llama_tensors():
        names.append(name)
        xs.append((torch.randn(shape, generator=gen, device=dev) * 0.05).to(torch.bfloat16))
    return names, xs


def llama_load(seed: int, dev):
    """The load's tensors (:func:`llama_tensors_on_card`) and their
    containers in the default per-chunk profile, written by
    ``ZipNN(engine="cuda")``."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415

    names, xs = llama_tensors_on_card(seed, dev)
    z = ZipNN(input_format="torch", engine="cuda", device=dev)
    return names, xs, [z.compress(x) for x in xs]


def serving_load(seed: int, dev, smi):
    """Phase 7: the Llama-3-8B two-layer load decoded on the card by
    ``ShardDecoder(to_device=True).decompress_iter``, by
    ``decompress_all`` (first call, then staged ``stack_groups`` replayed
    through ``decompress_groups``) and by one ``ZipNN.decompress`` per
    container in a row; every output equal to its original, the launch
    counts set to 0 before each way and read after.  Prints each way's wall
    and GB/s and the summed plan, stage and upload seconds."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.io.serving import ShardDecoder  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode, kernels, staging  # noqa: PLC0415

    t0 = time.perf_counter()
    names, xs, blobs = llama_load(seed, dev)
    nbytes = sum(x.numel() * 2 for x in xs)
    comp = sum(len(b) for b in blobs)
    k = names.index("model.layers.0.self_attn.k_proj.weight")
    golden = ZipNN(input_format="torch", engine="numpy").compress(xs[k].cpu())
    check(golden == blobs[k], "k_proj container from the card != golden")
    log(f"[serving] Llama-3-8B, {LLAMA3_8B['layers']} decoder layers: {len(xs)} bf16 tensors, "
        f"{nbytes} bytes -> {comp} bytes (ratio {comp / nbytes:.4f}), made and encoded on "
        f"the card in {time.perf_counter() - t0:.2f} s; k_proj's container == golden")

    def held(outs, way):
        check(len(outs) == len(xs), f"{way}: {len(outs)} outputs")
        for name, x, y in zip(names, xs, outs):
            y = y.view(torch.int16).reshape(-1) if y.dtype == torch.uint8 else y.view(torch.int16)
            check(y.device == x.device
                  and torch.equal(y.reshape(-1), x.view(torch.int16).reshape(-1)),
                  f"{way}: {name} != original")

    def summed(timings):
        return "plan {:.4f} s, stage {:.4f} s, upload {:.4f} s".format(
            *(sum(t[key] for t in timings) for key in ("plan_s", "stage_s", "upload_s")))

    def run(way, fn):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, timings = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        held(outs, way)
        for kname in ("huf_pc_decode", "combine_cells"):
            check(launches[kname] > 0, f"{kname} not launched by {way}")
        log(f"[serving] {way}: {wall:.4f} s = {nbytes / wall / 1e9:.3f} GB/s; "
            f"{summed(timings)}; launches {launches}; card: {smi}")
        return wall

    def per_container():
        outs, timings = [], []
        for b in blobs:
            outs.append(ZipNN(engine="cuda", device=dev).decompress(b))
            timings.append(dict(decode.last_timings))
        return outs, timings

    dec = ShardDecoder(to_device=True, device=dev)
    walls = {}
    walls["iter"] = run("ShardDecoder.decompress_iter", lambda: (list(dec.decompress_iter(blobs)),
                                                                 dec.timings))
    walls["all"] = run("ShardDecoder.decompress_all (first call)",
                       lambda: (dec.decompress_all(blobs), dec.timings))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    units = dec.stack_groups([dec.stage(b) for b in blobs])
    torch.cuda.synchronize()
    stage_wall = time.perf_counter() - t0
    log(f"[serving] stage + stack_groups of {len(blobs)} containers: {stage_wall:.4f} s")
    for rep in (1, 2):
        walls[f"groups{rep}"] = run(f"ShardDecoder.decompress_groups (staged, replay {rep})",
                                    lambda: (dec.decompress_groups(units), dec.timings))
    del units
    walls["zipnn"] = run("ZipNN.decompress per container", per_container)
    walls["iter2"] = run("ShardDecoder.decompress_iter (again)",
                         lambda: (list(dec.decompress_iter(blobs)), dec.timings))
    pool = staging.pool(dev)
    log(f"[serving] staging pool: {pool.held} pinned bytes held (bound {staging.POOL_BYTES}), "
        f"{pool.allocated} pinned allocations")
    return names, xs, blobs, walls


def checkpoint_save(names, xs, dev, smi) -> dict:
    """Phase 8: the load's tensors saved from the card in each profile:
    one ``ZipNN.compress`` per tensor, then ``ShardEncoder.compress_iter``
    with ``pool_staging`` off, and on (twice, each container only
    measured, then once more compared as it arrives); every container
    equal to the per-tensor one, k_proj's to the golden encoder's, all
    decoded back by ``ShardDecoder`` bit-exact; the launch counts set to 0
    before each way and read after.  Prints each way's wall and GB/s and
    the summed phase seconds; returns the launches of each profile's
    ``compress_iter``."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.io import serving  # noqa: PLC0415
    from zipnn_tpu_torch.ops import encode, kernels  # noqa: PLC0415

    nbytes = sum(x.numel() * 2 for x in xs)
    k = names.index("model.layers.0.self_attn.k_proj.weight")
    keys = ("plan_s", "kernels_s", "decide_s", "assemble_s", "splice_s", "download_s",
            "unstage_s")
    launches = {}

    def summed(timings):
        return ", ".join(f"{key[:-2]} {sum(t.get(key, 0.0) for t in timings):.4f} s"
                         for key in keys)

    for profile, kern in (("per_chunk", ("hist_cells", "huf_pc_encode")),
                          ("shared", ("const_scan_rows", "huf_shared_encode"))):
        z = ZipNN(input_format="torch", engine="cuda", huffman_table=profile, device=dev)

        def run(way, fn):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs, timings = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(kernels.launches)
            for kname in (*kern, "splice_cells"):
                check(got[kname] > 0, f"{kname} not launched by the {profile} {way}")
            log(f"[save] {profile} {way}: {wall:.4f} s = {nbytes / wall / 1e9:.3f} GB/s; "
                f"{summed(timings)}; launches {got}; card: {smi}")
            return outs, got

        def per_tensor():
            outs, timings = [], []
            for x in xs:
                outs.append(z.compress(x))
                timings.append(dict(encode.last_timings))
            return outs, timings

        want, _ = run("ZipNN.compress per tensor", per_tensor)
        golden = ZipNN(input_format="torch", engine="numpy",
                       huffman_table=profile).compress(xs[k].cpu())
        check(want[k] == golden, f"{profile} k_proj container != golden")
        enc = serving.ShardEncoder(z)
        outs, launches[profile] = run("ShardEncoder.compress_iter",
                                      lambda: (list(enc.compress_iter(xs)), enc.timings))
        check(outs == want, f"{profile} ShardEncoder containers != per-tensor ones")
        pooled = serving.ShardEncoder(z, pool_staging=True)
        for rep in (1, 2):
            run(f"ShardEncoder.compress_iter, pool_staging (run {rep})",
                lambda: ([len(v) for v in pooled.compress_iter(xs)], pooled.timings))
        for i, v in enumerate(pooled.compress_iter(xs)):
            check(v == want[i], f"{profile} pooled container {i} != per-tensor one")
        pinned = sum(b.numel() for b in serving._out_pool + pooled._held if b.is_pinned())
        dec = serving.ShardDecoder(to_device=True, device=dev)
        for name, x, y in zip(names, xs, dec.decompress_iter(outs)):
            check(torch.equal(y.view(torch.int16), x.view(torch.int16).reshape(-1)),
                  f"{profile} {name} does not decode back")
        log(f"[save] {profile}: {len(outs)} containers, {sum(len(o) for o in outs)} bytes "
            f"(ratio {sum(len(o) for o in outs) / nbytes:.4f}) == per tensor, k_proj == "
            f"golden, decoded back bit-exact by ShardDecoder; pooled output buffers: {pinned} "
            f"pinned bytes held")
        del want, outs, enc, pooled, dec
    return launches


ST_DTYPES = {torch.bfloat16: "BF16", torch.uint8: "U8"}


def safetensors_bytes(tensors: dict, metadata: dict) -> bytearray:
    """The safetensors layout of ``tensors`` ({name: CPU tensor}, in
    order), written here: an 8-byte little-endian header length, the JSON
    header (each tensor's dtype, shape and ``data_offsets``, and
    ``__metadata__``) padded with spaces to a multiple of 8 bytes, then the
    tensors' bytes back to back."""
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    header["__metadata__"] = metadata
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    out = bytearray(struct.pack("<Q", len(text)) + text)
    for t in tensors.values():
        out += t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return out


def safetensors_tensors(buf) -> dict:
    """{name: CPU tensor} parsed from the safetensors layout ``buf`` (bf16
    tensors only)."""
    mv = memoryview(buf)
    (hlen,) = struct.unpack("<Q", mv[:8])
    header = json.loads(bytes(mv[8 : 8 + hlen]))
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        check(info["dtype"] == "BF16", f"{name}: dtype {info['dtype']}")
        lo, hi = info["data_offsets"]
        raw = np.frombuffer(mv[8 + hlen + lo : 8 + hlen + hi], dtype=np.uint16).copy()
        out[name] = torch.from_numpy(raw).view(torch.bfloat16).reshape(info["shape"])
    return out


def whole_file_streaming(names, xs, dev, smi):
    """Phase 9: the load's tensors as one safetensors file in memory,
    compressed in 1 MiB streaming frames on the card (byte-equal to engine
    ``"native"``) and decompressed on the card, the frames decoded together;
    the launch counts set to 0 just before the decode and read just after.
    Returns the file's bytes and engine native's container."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode, kernels  # noqa: PLC0415

    host = {n: x.cpu() for n, x in zip(names, xs)}
    file = bytes(safetensors_bytes(host, {"format": "pt"}))
    frame = 1 << 20
    frames = -(-len(file) // frame)
    check(0 < len(file) % frame < 256 * 1024, "the last frame holds a full chunk")
    comp, enc_ms = host_ms(lambda: ZipNN(is_streaming=True, engine="cuda", device=dev)
                           .compress(file))
    nat, nat_ms = host_ms(lambda: ZipNN(is_streaming=True, engine="native").compress(file))
    check(comp == nat, "streaming container from the card != engine native's")

    gen2 = {"n": 0, "s": 0.0}  # full garbage collections, and their seconds

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                gen2["t0"] = time.perf_counter()
            else:
                gen2["n"] += 1
                gen2["s"] += time.perf_counter() - gen2["t0"]

    def dec():
        return ZipNN(is_streaming=True, engine="cuda", device=dev).decompress(comp)

    def timed_dec():
        n0, s0 = gen2["n"], gen2["s"]
        gc.callbacks.append(on_gc)
        try:
            out, ms = host_ms(dec)
        finally:
            gc.callbacks.remove(on_gc)
        t = dict(decode.last_timings, gen2=gen2["n"] - n0, gen2_s=gen2["s"] - s0)
        return out, ms, t

    kernels.reset_launches()
    out, ms, t = timed_dec()
    launches = dict(kernels.launches)
    check(out == file, "streaming decode != the file")
    check(t["frames"] == frames and t["runs"] == 1, f"{t['frames']} frames in {t['runs']} runs")
    check(0 < launches["huf_pc_decode"] < frames,
          f"huf_pc_decode launched {launches['huf_pc_decode']} times for {frames} frames")
    check(launches["combine_cells"] > 0, "combine_cells not launched by the streaming decode")
    got = safetensors_tensors(out)
    check(list(got) == names, "the decoded file's tensors")
    for name, x in host.items():
        check(torch.equal(got[name].view(torch.int16), x.view(torch.int16)), f"{name} != original")
    del out, got
    out, ms2, t2 = timed_dec()
    check(out == file, "second streaming decode != the file")
    del out
    # what one full collection of this process costs, whichever code it lands in
    full_s = time.perf_counter()
    gc.collect()
    full_s = time.perf_counter() - full_s
    tracked = len(gc.get_objects())
    one = bytes(ZipNN(engine="cuda", device=dev).compress(file))
    one_ms = []
    for _ in range(2):
        back, m = host_ms(lambda: ZipNN(engine="cuda", device=dev).decompress(one))
        check(back.nbytes == len(file), "one-container decode size")
        one_ms.append(m)
        del back
    n = len(file)

    def phases(tt):
        return (", ".join(f"{k[:-2]} {tt[k]:.4f} s" for k in (
            "runs_s", "plan_s", "geometry_s", "plan_cpu_s", "stage_s", "upload_s", "fetch_s"))
            + f", {tt['gen2']} full gc in {tt['gen2_s']:.4f} s")

    log(f"[stream] whole file: {len(names)} bf16 tensors as safetensors, {n} bytes -> "
        f"{frames} frames of 1 MiB ({len(comp)} bytes, ratio {len(comp) / n:.4f}); encode on "
        f"the card {enc_ms / 1e3:.3f} s = {n / enc_ms / 1e6:.3f} GB/s, == engine native "
        f"({nat_ms / 1e3:.3f} s); decode on the card {ms / 1e3:.4f} s = {n / ms / 1e6:.3f} GB/s "
        f"({phases(t)}), second {ms2 / 1e3:.4f} s = {n / ms2 / 1e6:.3f} GB/s ({phases(t2)}); "
        f"the same bytes as one container ({len(one)} bytes) decoded in "
        f"{one_ms[0] / 1e3:.4f} s, second {one_ms[1] / 1e3:.4f} s = "
        f"{n / one_ms[1] / 1e6:.3f} GB/s; a full gc of this process {full_s:.4f} s over "
        f"{tracked} tracked objects; launches {launches}; tensors parsed back bit-exact; "
        f"card: {smi}")
    return file, nat


def per_tensor_file(names, xs, blobs, iter_wall, dev, smi) -> None:
    """Phase 10: phase 7's containers as a ``.znn.safetensors`` file
    (``znn_compressed_vectors`` metadata, written here) read back onto the
    card by ``SafetensorsStreamReader.load_shard``; the launch counts set to
    0 just before each load and read just after."""
    from zipnn_tpu_torch.io.streaming import METADATA_KEY, SafetensorsStreamReader  # noqa: PLC0415
    from zipnn_tpu_torch.ops import kernels  # noqa: PLC0415

    stored = {n: torch.from_numpy(np.frombuffer(b, dtype=np.uint8).copy())
              for n, b in zip(names, blobs)}
    infos = {n: {"dtype": "bfloat16", "shape": str(list(x.shape))} for n, x in zip(names, xs)}
    path = kernels.BUILD_DIR / "smoke_llama.znn.safetensors"
    path.write_bytes(safetensors_bytes(stored, {"format": "pt",
                                                METADATA_KEY: json.dumps(infos)}))
    del stored
    nbytes = sum(x.numel() * 2 for x in xs)
    try:
        reader = SafetensorsStreamReader(str(path), decode_device=dev)
        check(set(reader.compressed) == set(names), "compressed tensors of the file")
        for rep in (1, 2):
            kernels.reset_launches()
            got, ms = host_ms(lambda: reader.load_shard(device=dev))
            launches = dict(kernels.launches)
            for name, x in zip(names, xs):
                y = got[name]
                check(y.device == x.device and y.dtype == x.dtype and torch.equal(
                    y.view(torch.int16), x.view(torch.int16)), f"{name} != original")
            for k in ("huf_pc_decode", "combine_cells"):
                check(launches[k] > 0, f"{k} not launched by load_shard")
            del got
            log(f"[file] SafetensorsStreamReader.load_shard onto the card (run {rep}): "
                f"{path.stat().st_size} bytes of file, {len(names)} tensors bit-exact, "
                f"{ms / 1e3:.4f} s = {nbytes / ms / 1e6:.3f} GB/s (phase 7's "
                f"ShardDecoder.decompress_iter of the same containers: {iter_wall:.4f} s = "
                f"{nbytes / iter_wall / 1e9:.3f} GB/s); launches {launches}; card: {smi}")
    finally:
        path.unlink()


def delta_case(names, xs, seed, dev, smi) -> None:
    """Phase 11: layer 0's q_proj as the base, the base plus N(0, 1e-3)
    (``seed``) in bf16 as the fine-tuned tensor; the byte-format delta
    container, plain and streaming, byte-equal between engines ``"cuda"``
    and ``"native"``, decoded on the card back to the fine-tuned bytes.
    Returns the (base, fine-tuned) bytes."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import kernels  # noqa: PLC0415

    b = xs[names.index("model.layers.0.self_attn.q_proj.weight")]
    gen = torch.Generator(device=dev).manual_seed(seed)
    tuned = (b.float() + torch.randn(b.shape, generator=gen, device=dev) * 1e-3).to(b.dtype)
    base = b.cpu().view(torch.int16).numpy().tobytes()
    tuned = tuned.cpu().view(torch.int16).numpy().tobytes()
    check(base != tuned, "the fine-tuned tensor equals the base")
    for streaming in (False, True):
        kw = {"delta_compressed_type": "byte", "is_streaming": streaming}
        c, enc_ms = host_ms(lambda: ZipNN(engine="cuda", device=dev, **kw)
                            .compress(tuned, delta_second_data=base))
        nat, nat_ms = host_ms(lambda: ZipNN(engine="native", **kw)
                              .compress(tuned, delta_second_data=base))
        check(c == nat, f"delta container (streaming {streaming}) != engine native's")
        kernels.reset_launches()
        back, dec_ms = host_ms(lambda: ZipNN(engine="cuda", device=dev, **kw)
                               .decompress(c, delta_second_data=base))
        launches = dict(kernels.launches)
        check(bytes(back) == tuned, f"delta decode (streaming {streaming}) != fine-tuned bytes")
        check(launches["combine_cells"] > 0, "combine_cells not launched by the delta decode")
        log(f"[delta] q_proj {len(base)} bytes, streaming {streaming}: container {len(c)} bytes "
            f"(ratio {len(c) / len(base):.4f}) == engine native; encode on the card "
            f"{enc_ms / 1e3:.4f} s (native {nat_ms / 1e3:.4f} s), decode on the card "
            f"{dec_ms / 1e3:.4f} s = {len(base) / dec_ms / 1e6:.3f} GB/s, == fine-tuned bytes; "
            f"launches {launches}; card: {smi}")
    return base, tuned


def lossy_input(seed: int) -> torch.Tensor:
    """Phase 12's fp32 input: 64 MiB of N(0, 0.05)."""
    return synth(torch.float32, 64 << 20, seed)


def lossy_case(label, x_cpu, factor, is_int, dev, smi) -> dict:
    """Phase 12, one input: encoded on the card from a CUDA tensor,
    byte-equal to engine ``"native"``'s container (``lossy_is_int`` as
    ``is_int``), decoded on the card to the tensor engine ``"numpy"``
    decodes; the launch counts set to 0 just before the decode and read
    just after, and returned."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import kernels  # noqa: PLC0415

    kw = {"input_format": "torch", "lossy_compressed_type": "integer",
          "lossy_compressed_factor": factor}
    x = x_cpu.to(dev)
    c, enc_ms = host_ms(lambda: ZipNN(engine="cuda", device=dev, **kw).compress(x))
    check(c == ZipNN(engine="native", **kw).compress(x_cpu), f"{label}: container != native's")
    check(c[12] == int(is_int), f"{label}: lossy_is_int {c[12]}")
    want, numpy_ms = host_ms(lambda: ZipNN(input_format="torch", engine="numpy").decompress(c))
    kernels.reset_launches()
    y, dec_ms = host_ms(lambda: ZipNN(input_format="torch", engine="cuda", device=dev)
                        .decompress(c))
    launches = dict(kernels.launches)
    ints = {4: torch.int32, 2: torch.int16}[x_cpu.element_size()]
    check(y.device == x.device and y.dtype == x_cpu.dtype and y.shape == x_cpu.shape,
          f"{label}: output")
    check(torch.equal(y.cpu().view(ints), want.view(ints)), f"{label}: card != engine numpy")
    check(launches["combine_cells"] > 0, f"{label}: combine_cells not launched")
    err = float((y.float() - x.float()).abs().max())
    n = x_cpu.numel() * x_cpu.element_size()
    log(f"[lossy] {label}: {n} bytes, factor {factor}, lossy_is_int {c[12]}, container "
        f"{len(c)} bytes (ratio {len(c) / n:.4f}) == engine native; encode on the card "
        f"{enc_ms / 1e3:.4f} s, decode on the card {dec_ms / 1e3:.4f} s = "
        f"{n / dec_ms / 1e6:.3f} GB/s == engine numpy ({numpy_ms / 1e3:.1f} s); max |error| "
        f"{err:.3g}; launches {launches}; card: {smi}")
    return launches


def sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def cli_call(main, argv) -> tuple:
    """(ms, standard output) of ``main(argv)``, a CLI's entry point run in
    this process, synchronised; its output is logged too, and an ``ERROR``
    line (the path scripts' report of a failed file) fails the run."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, ms = host_ms(lambda: main(argv))
    text = out.getvalue()
    for line in text.splitlines():
        log(f"[cli]   {line}")
    check("ERROR" not in text, f"{argv}: a file failed")
    return ms, text


def cli_container(nat: bytes) -> str:
    """SHA-256 of phase 9's engine native container as ``compress_file``
    writes it: the same frames with the method byte of each frame's header
    (byte 7) set to the CLI's default ``--method HUFFMAN`` (phase 9's
    ``ZipNN`` has the default method, AUTO)."""
    from zipnn_tpu_torch.core.enums import EnumMethod  # noqa: PLC0415
    from zipnn_tpu_torch.core.header import walk_frames  # noqa: PLC0415

    buf = bytearray(nat)
    for off, _ in walk_frames(memoryview(nat)):
        buf[off + 7] = EnumMethod("HUFFMAN").value
    return hashlib.sha256(buf).hexdigest()


def hold_cli_kernels(file: bytes, znn: bytes, dev) -> dict:
    """Phase 13a: the CLI path's kernels against their plain versions at
    the shapes that path gives them, each timed as in phase 2:
    ``hist_cells``, ``huf_pc_encode`` and ``splice_cells`` on the batch of
    the file's first 1 MiB frame (``compress_file`` encodes one frame at a
    time: 4 chunks of 256 KB), K1 and K2 on the first batch of the .znn's
    first run of frames (``decompress_file`` decodes a run as one
    container).  Returns {row key of the ``kernels`` line: its numbers}."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode, huf_pc  # noqa: PLC0415

    frame = torch.frombuffer(bytearray(file[: 1 << 20]), dtype=torch.bfloat16)
    held = {}
    held["hist"], held["k7pc"], _ = hold_pc_encode_kernels(frame, dev, min_chunks=4)
    want = bytes(ZipNN(input_format="torch", engine="native").compress(frame))
    held["splice_pc"] = hold_splice(frame, {"per_chunk": want}, dev)["per_chunk"]
    mv = memoryview(znn)
    run = decode.frame_runs(mv)[0]
    plan = decode.build_plan(mv, *run.key, run.orig_size, frames=run.frames)
    lo, hi = decode.plan_batches(plan.g.n_chunks, plan.g.chunk_size)[0]
    dv = decode.DeviceInputs(plan, dev)
    torch.cuda.current_stream(dev).wait_event(dv.upload(0))
    k1a = dv.k1_args(lo, hi)
    sym, held["k1_bf16"] = hold_decode(
        f"huf_pc_decode (CLI: first run of {run.n_frames} frames, {hi - lo} chunks)", huf_pc,
        huf_pc.huf_pc_decode, huf_pc.huf_pc_decode_plain, k1a, k1_table_bytes(k1a))
    cs = plan.g.chunk_size
    original = torch.frombuffer(bytearray(file[lo * cs : hi * cs]), dtype=torch.uint8)
    held["k2_2"] = hold_combine(f"combine_cells (CLI: first run of {run.n_frames} frames)",
                                plan, dv.k2_args(lo, hi, sym), original, lo, hi)
    return held


def cli_file(file: bytes, nat: bytes, d: Path, smi) -> dict:
    """Phase 13a and e: ``compress_file`` / ``decompress_file`` on the card
    over phase 9's file, beside ``--engine native``, and once with
    ``--huffman_table shared``; the path's kernels held against their
    plain versions at its shapes (:func:`hold_cli_kernels`);
    ``stats.file_stats`` of the .znn.  Returns the launches of the counted
    runs and the held kernels' numbers."""
    from zipnn_tpu_torch import stats  # noqa: PLC0415
    from zipnn_tpu_torch.cli import compress_file, decompress_file  # noqa: PLC0415
    from zipnn_tpu_torch.ops import kernels  # noqa: PLC0415

    nat_sha = cli_container(nat)

    path = d / "model.safetensors"
    znn = Path(str(path) + ".znn")
    path.write_bytes(file)
    n, frames = len(file), -(-len(file) // (1 << 20))
    launches = {}

    def timings(t):
        return ", ".join(f"{k[:-2]} {v:.4f} s" for k, v in t.items())

    def compress(label, *flags, must_launch=()):
        kernels.reset_launches()
        ms, _ = cli_call(compress_file.main, [str(path), "--force", *flags])
        got = dict(kernels.launches)
        for k in must_launch:
            check(got[k] > 0, f"compress_file {label}: {k} not launched")
        log(f"[cli] compress_file {label}: {n} bytes -> {znn.stat().st_size}, wall "
            f"{ms / 1e3:.4f} s ({timings(compress_file.last_timings)}), compress "
            f"{n / compress_file.last_timings['compress_s'] / 1e9:.3f} GB/s; launches {got}; "
            f"card: {smi}")
        return got

    def decompress(label):
        path.unlink()
        kernels.reset_launches()
        ms, _ = cli_call(decompress_file.main, [str(znn), "--force"])
        got = dict(kernels.launches)
        check(path.read_bytes() == file, f"decompress_file {label}: != the file")
        check(0 < got["huf_pc_decode"] < frames,
              f"decompress_file {label}: huf_pc_decode launched {got['huf_pc_decode']} times "
              f"for {frames} frames")
        check(got["combine_cells"] > 0, f"decompress_file {label}: combine_cells not launched")
        log(f"[cli] decompress_file {label}: wall {ms / 1e3:.4f} s "
            f"({timings(decompress_file.last_timings)}), decompress "
            f"{n / decompress_file.last_timings['decompress_s'] / 1e9:.3f} GB/s; == the file; "
            f"launches {got}; card: {smi}")
        return got

    launches["compress"] = compress("(engine cuda)", must_launch=(
        "hist_cells", "huf_pc_encode", "splice_cells"))
    check(sha(znn) == nat_sha, "compress_file's .znn != phase 9's engine native container "
          "(with the CLI's method byte)")
    info = stats.file_stats(str(znn))
    check(len(info["frames"]) == frames == 833 and info["total_len"] == znn.stat().st_size
          and info["original_len"] == n, f"file_stats: {len(info['frames'])} frames, "
          f"{info['total_len']} bytes")
    huf = sum(p["huffman_chunks"] for f in info["frames"] for p in f.get("planes", []))
    log(f"[stats] file_stats of the .znn: {len(info['frames'])} frames, {info['total_len']} "
        f"bytes (ratio {info['ratio']:.4f}), {huf} Huffman cells")
    launches["decompress"] = decompress("(engine cuda)")
    held = hold_cli_kernels(file, znn.read_bytes(), torch.device("cuda"))
    compress("--engine native", "--engine", "native")
    check(sha(znn) == nat_sha, "compress_file --engine native's .znn != phase 9's")
    launches["shared"] = compress("--huffman_table shared", "--huffman_table", "shared",
                                  must_launch=("const_scan_rows", "huf_shared_encode",
                                               "splice_cells"))
    # each 1 MiB frame has its own shared table, so the frames' cells do not
    # share one header and the run decodes by K1 (decode.takes_shared_table)
    launches["shared_decompress"] = decompress("--huffman_table shared")
    return {"launches": launches, "held": held}


def cli_delta(base: bytes, tuned: bytes, d: Path, smi) -> None:
    """Phase 13b: phase 11's q_proj pair as two files through
    ``compress_file_delta`` (byte-equal to ``--engine native``) and
    ``decompress_file_delta`` on the card."""
    from zipnn_tpu_torch.cli import compress_file_delta, decompress_file_delta  # noqa: PLC0415

    b, t = d / "q_proj.base.bin", d / "q_proj.tuned.bin"
    b.write_bytes(base)
    t.write_bytes(tuned)
    znn = Path(str(t) + ".znn")
    ms, _ = cli_call(compress_file_delta.main, [str(t), str(b), "--force"])
    got = sha(znn)
    nat_ms, _ = cli_call(compress_file_delta.main, [str(t), str(b), "--force", "--engine", "native"])
    check(got == sha(znn), "compress_file_delta on the card != --engine native")
    t.unlink()
    dec_ms, _ = cli_call(decompress_file_delta.main, [str(znn), str(b), "--force"])
    check(t.read_bytes() == tuned, "decompress_file_delta != the fine-tuned bytes")
    log(f"[cli] delta q_proj {len(tuned)} bytes: compress_file_delta {ms / 1e3:.4f} s "
        f"(--engine native {nat_ms / 1e3:.4f} s, same file), decompress_file_delta "
        f"{dec_ms / 1e3:.4f} s, == the fine-tuned bytes; card: {smi}")


def cli_path(file: bytes, d: Path, smi) -> None:
    """Phase 13c: ``compress_path bin --max_processes 2`` and
    ``decompress_path`` on the card in spawned workers over three of the
    file's tensors as separate files; each .znn equals the one
    ``compress_file`` writes for that file, and every file comes back."""
    from zipnn_tpu_torch.cli import compress_file, compress_path, decompress_path  # noqa: PLC0415

    tensors = safetensors_tensors(file)
    pick = [f"model.layers.0.self_attn.{k}.weight" for k in ("k_proj", "v_proj", "q_proj")]
    batch, one = d / "batch", d / "one"
    batch.mkdir()
    one.mkdir()
    want = {}
    for name in pick:
        raw = tensors[name].view(torch.int16).numpy().tobytes()
        for folder in (batch, one):
            (folder / f"{name}.bin").write_bytes(raw)
        out = compress_file.compress_file(str(one / f"{name}.bin"), force=True)
        want[name] = (raw, sha(out))
    del tensors
    ms, _ = cli_call(compress_path.main, ["bin", "--path", str(batch), "--force",
                                          "--max_processes", "2"])
    for name, (raw, digest) in want.items():
        check(sha(batch / f"{name}.bin.znn") == digest,
              f"compress_path's {name}.bin.znn != compress_file's")
        (batch / f"{name}.bin").unlink()
    dec_ms, _ = cli_call(decompress_path.main, ["--path", str(batch), "--force",
                                                "--max_processes", "2"])
    for name, (raw, _) in want.items():
        check((batch / f"{name}.bin").read_bytes() == raw, f"decompress_path: {name} != original")
    n = sum(len(r) for r, _ in want.values())
    log(f"[cli] compress_path / decompress_path bin --max_processes 2 (spawned workers) over "
        f"{len(want)} files ({n} bytes): {ms / 1e3:.3f} s / {dec_ms / 1e3:.3f} s, every .znn "
        f"== compress_file's, every file back; card: {smi}")


def device_events(prof):
    """The trace's device events (kernels and copies) as (name, start us,
    end us); the spans of ``record_function`` that the trace mirrors on the
    device's timeline (user annotations: ``znn:`` and the window's own)
    are not device work."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith("znn")]


def busy_share(prof, label: str, kernels_only: bool = False) -> tuple:
    """(device-busy microseconds inside the ``label`` span, the span's
    microseconds): the union of the device events' intervals (kernels
    only, or copies too), clipped to the span."""
    span = next(e for e in prof.events() if e.name == label)
    lo, hi = span.time_range.start, span.time_range.end
    busy, end = 0.0, lo
    for name, a, b in sorted(device_events(prof), key=lambda x: x[1]):
        if kernels_only and ("Memcpy" in name or "Memset" in name):
            continue
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy, hi - lo


def traced(label, fn, kernel_names, spans, event_ms, log_dir, smi) -> dict:
    """Phase 13d, one call: ``fn()`` once warm, then once inside
    ``stats.trace``; the trace must hold each kernel of ``kernel_names``
    ({kernel: its ``__global__`` function}) and each ``znn:`` span of
    ``spans``.  Logs each kernel's profiler times beside its phase-2
    CUDA-event ms (``event_ms``) and the device's busy share of the
    traced window; returns {kernel: largest profiler ms}."""
    from zipnn_tpu_torch import stats  # noqa: PLC0415

    fn()
    torch.cuda.synchronize()
    with stats.trace(str(log_dir), label=f"znn-smoke:{label}") as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    for sp in spans:
        check(f"znn:{sp}" in names, f"trace of {label}: no znn:{sp} span")
    dev = device_events(prof)
    out, parts = {}, []
    for k, fname in kernel_names.items():
        ms = [(b - a) / 1e3 for n, a, b in dev if fname in n]
        check(ms, f"trace of {label}: no {fname} kernel")
        out[k] = max(ms)
        parts.append(f"{k} ({fname}) {len(ms)} launches, "
                     f"{', '.join(f'{m:.3f}' for m in ms)} ms (phase 2's events: "
                     f"{event_ms[k]:.3f} ms, {max(ms) / event_ms[k] - 1:+.1%})")
    busy, window = busy_share(prof, f"znn-smoke:{label}")
    kinds = {}
    for n, _, _ in dev:
        kinds[n[:48]] = kinds.get(n[:48], 0) + 1
    kbusy, _ = busy_share(prof, f"znn-smoke:{label}", kernels_only=True)
    log(f"[trace] {label}: {'; '.join(parts)}; device busy (kernels and copies) "
        f"{busy / 1e3:.3f} of {window / 1e3:.3f} ms traced ({busy / window:.1%}, idle "
        f"{1 - busy / window:.1%}; kernels alone {kbusy / 1e3:.3f} ms, {kbusy / window:.1%}); "
        f"{len(dev)} device events ({kinds}); "
        f"{sum(1 for n in names if n.startswith('znn:'))} znn: span names; card: {smi}")
    return out


def cli_and_trace(file, nat, base, tuned, c_bf16, x_bf16, event_ms, dev, smi) -> dict:
    """Phase 13, in a temporary directory removed at the end, whatever
    happens: the CLI on the card (a-c), a ``stats.trace`` of a decode and
    an encode (d), ``stats.file_stats`` (e, inside a).  Returns the
    launches of a's counted runs, a's held kernels and the profiler's
    kernel ms."""
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415

    d = Path(tempfile.mkdtemp(prefix="znn-smoke-cli-"))
    try:
        out = cli_file(file, nat, d, smi)
        cli_delta(base, tuned, d, smi)
        cli_path(file, d, smi)
        z = ZipNN(input_format="torch", engine="cuda", device=dev)
        x_dev = x_bf16.to(dev)
        y = z.decompress(c_bf16)
        check(torch.equal(y.view(torch.int16), x_dev.view(torch.int16)), "traced decode input")
        del y
        prof_ms = traced("decode bf16 per-chunk", lambda: z.decompress(c_bf16),
                         {"k1_bf16": "huf_pc_decode_kernel", "k2_2": "combine_cells_kernel"},
                         ("decode:plan", "decode:geometry", "decode:plan-tables",
                          "decode:upload", "decode:stage"), event_ms, d / "trace_dec", smi)
        check(bytes(z.compress(x_dev)) == c_bf16, "traced encode input")
        prof_ms.update(traced(
            "encode bf16 per-chunk", lambda: z.compress(x_dev),
            {"hist": "hist_cells_kernel", "k7pc": "huf_encode_warps_kernel",
             "splice_pc": "splice_kernel"},
            ("encode:split", "encode:hist", "encode:plan", "encode:kernel", "encode:decide",
             "encode:assemble", "encode:splice", "encode:download", "encode:unstage"),
            event_ms, d / "trace_enc", smi))
        return {**out, "profiler_ms": prof_ms}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def cpu_model() -> str:
    """The host CPU's model (``lscpu``'s "Model name", else
    ``/proc/cpuinfo``'s "model name"), with its core count: the plan and
    splice are host timings."""
    lines = []
    try:
        lines = subprocess.run(["lscpu"], capture_output=True, text=True,
                               check=False).stdout.splitlines()
    except OSError:
        pass
    try:
        lines += Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        pass
    model = next((ln.split(":", 1)[1].strip() for ln in lines
                  if ln.strip().lower().startswith("model name")), "unknown")
    return f"{model} ({os.cpu_count()} cores)"


MESH_RANKS = 2  # phase 14b's processes, all on the one card


def mesh_paths(x_bf16, x_fp32, goldens: dict, dev, smi) -> dict:
    """Phase 14a: ``ZipNN(input_format="torch")`` on the bf16 tensor (both
    profiles) and the fp32 one (per-chunk) with no mesh, under
    ``make_mesh([dev, dev])`` (two shards on the one card) and under
    ``make_mesh()`` (every card), then with no mesh again (a warm
    baseline): each container byte-equal to the golden
    one (which phase 6 showed the card writes with no mesh), each decode
    onto the card bit-exact, and each kernel's launches the mesh's entries
    times the no-mesh call's (every batch has a launch set a shard); the
    launch counts set to 0 just before each call and read just after.
    Returns the 2-shard runs' launches by "case:encode" / "case:decode"."""
    from zipnn_tpu_torch import ZipNN, parallel  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode, encode, kernels  # noqa: PLC0415

    meshes = {"2 shards on one card": parallel.make_mesh([dev, dev]),
              "make_mesh()": parallel.make_mesh()}
    cases = (("bf16 per-chunk", x_bf16, "per_chunk", goldens["bf16"]),
             ("bf16 shared", x_bf16, "shared", goldens["shared"]),
             ("fp32 per-chunk", x_fp32, "per_chunk", goldens["fp32"]))
    out = {}
    for label, x, profile, want in cases:
        ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
        x_dev = x.to(dev)
        n = x.numel() * x.element_size()
        runs = {}
        # no mesh first (its launches are the baseline) and again last: the
        # first call of a case is the cold one
        for mlabel, mesh in (("no mesh", None), *meshes.items(), ("no mesh, again", None)):
            with parallel.use_mesh(mesh):
                kernels.reset_launches()
                (got, enc_ms) = host_ms(lambda: ZipNN(input_format="torch",
                                                      huffman_table=profile).compress(x))
                enc = dict(kernels.launches)
                et = dict(encode.last_timings)
                check(bytes(got) == want, f"{label} under {mlabel}: container != golden")
                del got
                kernels.reset_launches()
                (y, dec_ms) = host_ms(lambda: ZipNN(input_format="torch").decompress(want))
                dec = dict(kernels.launches)
                dt = dict(decode.last_timings)
                check(y.is_cuda and torch.equal(y.view(ints), x_dev.view(ints)),
                      f"{label} under {mlabel}: decode onto the card != original")
                del y
            runs[mlabel] = (enc_ms, dec_ms, enc, dec, et, dt)
        # every (batch, shard) range launches the set that each batch
        # launches with no mesh; a batch of fewer chunks than shards (the
        # decode's last batch holds the tail chunk alone) has fewer ranges
        chunk, nb = 256 * 1024, x.element_size()
        batches = {"encode": encode.Geometry(n, nb, chunk, profile == "shared").batches,
                   "decode": decode.plan_batches(-(-n // chunk), chunk)}
        base = runs["no mesh"]
        for mlabel, mesh in meshes.items():
            for what, i in (("encode", 2), ("decode", 3)):
                ranges = sum(min(mesh.size, hi - lo) for lo, hi in batches[what])
                check(runs[mlabel][i + 2]["shards"] == ranges,
                      f"{label} {what} under {mlabel}: {runs[mlabel][i + 2]['shards']} "
                      f"ranges, want {ranges}")
                for k, v in base[i].items():
                    want_k = v // len(batches[what]) * ranges
                    check(v % len(batches[what]) == 0 and runs[mlabel][i][k] == want_k,
                          f"{label} {what} under {mlabel}: {k} launched "
                          f"{runs[mlabel][i][k]} times, want {want_k}")
        for mlabel in runs:
            enc_ms, dec_ms, enc, dec, et, dt = runs[mlabel]
            log(f"[mesh] {label}, {mlabel}: encode {enc_ms / 1e3:.4f} s = "
                f"{n / enc_ms / 1e6:.3f} GB/s ({et['batches']} batch(es) x "
                f"{et['shards'] // et['batches']} shard(s); launches "
                f"{ {k: v for k, v in enc.items() if v} }), == golden; decode onto the card "
                f"{dec_ms / 1e3:.4f} s = {n / dec_ms / 1e6:.3f} GB/s (launches "
                f"{ {k: v for k, v in dec.items() if v} }), bit-exact")
        out[f"{label}:encode"] = runs["2 shards on one card"][2]
        out[f"{label}:decode"] = runs["2 shards on one card"][3]
        del x_dev
        torch.cuda.empty_cache()
    log(f"[mesh] every kernel launched once a (batch, shard) range for each launch a batch "
        f"makes with no mesh; card: {smi}")
    return out


def mesh_holds(x_bf16, x_fp32, goldens: dict, dev) -> dict:
    """Phase 14a: each kernel of the mesh's paths against its plain version
    at the first shard of the 2-shard mesh's first batch (half of phase
    2's shapes), timed as in phase 2: K1 (bf16, fp32), K2 (2 and 4
    planes), K6, K8, K7, H, E, and ``splice_cells`` (both profiles: the
    first splice of an encode under the mesh is its first shard's)."""
    from zipnn_tpu_torch import parallel  # noqa: PLC0415
    from zipnn_tpu_torch.ops import huf_pc, huf_shared  # noqa: PLC0415

    rows = {}
    for tag, k1, k2, x in (("bf16", "k1_bf16", "k2_2", x_bf16),
                           ("fp32", "k1_fp32", "k2_4", x_fp32)):
        plan, dv, (lo, hi) = plan_of(goldens[tag], dev)
        a, b = first_shard(lo, hi, 2)
        k1a = dv.k1_args(a, b)
        sym, rows[k1] = hold_decode(f"huf_pc_decode ({tag}, shard 0 of 2: {b - a} chunks)",
                                    huf_pc, huf_pc.huf_pc_decode, huf_pc.huf_pc_decode_plain,
                                    k1a, k1_table_bytes(k1a))
        rows[k2] = hold_combine(f"combine_cells ({tag}, shard 0 of 2)", plan,
                                dv.k2_args(a, b, sym), x, a, b)
        del dv, sym, k1a
    plan, dv, (lo, hi) = plan_of(goldens["shared"], dev)
    a, b = first_shard(lo, hi, 2)
    _, rows["k6"] = hold_decode(f"huf_shared_decode (bf16 shared, shard 0 of 2: {b - a} chunks)",
                                huf_shared, huf_shared.huf_shared_decode,
                                huf_shared.huf_shared_decode_plain, dv.k6_args(a, b), 512)
    del dv
    rows["k8"], rows["k7"] = hold_encode_kernels(x_bf16, dev, parts=2)
    rows["hist"], rows["k7pc"], _ = hold_pc_encode_kernels(x_bf16, dev, parts=2)
    with parallel.use_mesh(parallel.make_mesh([dev, dev])):
        spl = hold_splice(x_bf16, {"per_chunk": goldens["bf16"], "shared": goldens["shared"]},
                          dev)
    rows["splice_pc"], rows["splice_shared"] = spl["per_chunk"], spl["shared"]
    torch.cuda.empty_cache()
    return rows


def rank_worker(rank: int, address: str, jobs: list, times_path: str) -> None:
    """Phase 14b: one of the ``MESH_RANKS`` spawned processes: joins the
    gloo group and runs every job of ``jobs`` (``multihost`` function name,
    arguments, keywords) in order; rank 0 writes each job's
    ``multihost.last_timings`` to ``times_path``."""
    sys.path.insert(0, str(ROOT))
    from zipnn_tpu_torch.parallel import multihost  # noqa: PLC0415

    multihost.initialize(address, MESH_RANKS, rank, timeout_s=240)
    times = []
    for fn, args, kw in jobs:
        getattr(multihost, fn)(*args, **kw)
        times.append(dict(multihost.last_timings))
    if rank == 0:
        Path(times_path).write_text(json.dumps(times))


def two_ranks(file: bytes, dev, smi) -> None:
    """Phase 14b: two processes started by ``spawn`` on the one card, over
    gloo, on phase 9's file (written to a temporary directory, removed at
    the end): ``compress_file_multihost`` per-chunk (the 10 % bounded
    check's decision agreed through ``raw_planes``) and shared (a preset
    table from the summed sampled counts), each then
    ``decompress_file_multihost``; the streaming mode on the file's first
    64 MiB; ``compress_safetensors_multihost``.  Each file equals the one
    of one process (``ZipNN(input_format="byte",
    bytearray_dtype="bfloat16")`` on the card; engine native's for the
    streaming one; the same call with no process group for the
    safetensors one) and each decompressed file the input; the
    safetensors file loads back bit-exact through
    ``SafetensorsStreamReader`` (``SafeOpen`` needs the ``safetensors``
    package, which the card's host may lack).  Beside them, one process's
    ``compress_file_multihost(engine="native")`` of the same file."""
    import multiprocessing  # noqa: PLC0415
    import socket  # noqa: PLC0415

    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.io.streaming import SafetensorsStreamReader  # noqa: PLC0415
    from zipnn_tpu_torch.parallel import multihost  # noqa: PLC0415

    d = Path(tempfile.mkdtemp(prefix="znn_ranks_"))
    try:
        src, head = d / "model.safetensors", d / "head.bin"
        src.write_bytes(file)
        head.write_bytes(file[: 64 << 20])
        n = len(file)
        wants = {}
        for key, kw in (("per_chunk", {}), ("shared", {"huffman_table": "shared"})):
            wants[key], ms = host_ms(lambda: bytes(ZipNN(bytearray_dtype="bfloat16", **kw)
                                                   .compress(file)))
            log(f"[ranks] one process, {key}: ZipNN.compress on the card {ms / 1e3:.4f} s = "
                f"{n / ms / 1e6:.3f} GB/s ({len(wants[key])} bytes)")
        _, ms = host_ms(lambda: multihost.compress_file_multihost(
            str(src), str(d / "native.znn"), engine="native"))
        check((d / "native.znn").read_bytes() == wants["per_chunk"],
              "one process's compress_file_multihost(engine='native') != ZipNN's container")
        t = multihost.last_timings
        log(f"[ranks] one process, per-chunk, compress_file_multihost(engine='native'): "
            f"{ms / 1e3:.4f} s = {n / ms / 1e6:.3f} GB/s (read {t['read_s']:.4f}, compress "
            f"{t['compress_s']:.4f}, write {t['write_s']:.4f} s), == ZipNN's container")
        wants["stream"] = bytes(ZipNN(is_streaming=True, engine="native")
                                .compress(file[: 64 << 20]))
        st1 = d / "one.znn.safetensors"
        _, st_ms = host_ms(lambda: multihost.compress_safetensors_multihost(str(src), str(st1)))
        log(f"[ranks] one process, compress_safetensors_multihost on the card: "
            f"{st_ms / 1e3:.4f} s")

        jobs = [("compress_file_multihost", (str(src), str(d / "pc.znn")), {}),
                ("decompress_file_multihost", (str(d / "pc.znn"), str(d / "pc.bin")), {}),
                ("compress_file_multihost", (str(src), str(d / "sh.znn")),
                 {"huffman_table": "shared"}),
                ("decompress_file_multihost", (str(d / "sh.znn"), str(d / "sh.bin")), {}),
                ("compress_file_multihost", (str(head), str(d / "st.znn")),
                 {"is_streaming": True}),
                ("decompress_file_multihost", (str(d / "st.znn"), str(d / "st.bin")), {}),
                ("compress_safetensors_multihost", (str(src), str(d / "two.znn.safetensors")),
                 {})]
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
        ctx = multiprocessing.get_context("spawn")  # a forked child cannot use CUDA
        t0 = time.perf_counter()
        procs = [ctx.Process(target=rank_worker, args=(r, address, jobs, str(d / "times.json")))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=300)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        wall = time.perf_counter() - t0
        check(all(p.exitcode == 0 for p in procs),
              f"a rank failed: exit codes {[p.exitcode for p in procs]}")
        times = json.loads((d / "times.json").read_text())
        for (fn, args, kw), t in zip(jobs, times):
            what = "".join(f" {k}={v}" for k, v in kw.items())
            log(f"[ranks] rank 0 of {MESH_RANKS}, {fn}({Path(args[0]).name}{what}): "
                f"{t['wall_s']:.4f} s (read {t.get('read_s', 0):.4f}, compress "
                f"{t.get('compress_s', 0):.4f}, decompress {t.get('decompress_s', 0):.4f}, "
                f"collective {t.get('collective_s', 0):.4f}, write {t.get('write_s', 0):.4f} s)")
        check((d / "pc.znn").read_bytes() == wants["per_chunk"],
              "two ranks' per-chunk container != one process's")
        check((d / "sh.znn").read_bytes() == wants["shared"],
              "two ranks' shared container != one process's")
        check((d / "st.znn").read_bytes() == wants["stream"],
              "two ranks' streaming container != one process's")
        check((d / "pc.bin").read_bytes() == file and (d / "sh.bin").read_bytes() == file
              and (d / "st.bin").read_bytes() == file[: 64 << 20],
              "a two-rank decompress != the input")
        check((d / "two.znn.safetensors").read_bytes() == st1.read_bytes(),
              "two ranks' .znn.safetensors != one process's")
        src_rdr = SafetensorsStreamReader(str(src))
        rdr = SafetensorsStreamReader(str(d / "two.znn.safetensors"))
        check(set(rdr.compressed) == set(src_rdr.keys()), "a tensor was not compressed")
        for name, x in src_rdr.load_shard(device=dev).items():
            y = rdr.get_tensor(name, device=dev)
            check(y.dtype == x.dtype and torch.equal(y.view(torch.uint8), x.view(torch.uint8)),
                  f"{name} of the two-rank .znn.safetensors != the original")
        log(f"[ranks] {MESH_RANKS} spawned ranks on {torch.cuda.get_device_name(0)}, gloo: "
            f"{len(jobs)} jobs in {wall:.4f} s (process starts included); every container "
            f"== one process's, every file decompressed back exactly, the .znn.safetensors "
            f"({len(rdr.compressed)} tensors) loaded bit-exact; card: {smi}")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def entry_phase(dev) -> None:
    """Phase 14c: ``entry.entry()``'s decode step (K1 then K2) on the card,
    bit-exact, and ``entry.dryrun_multichip(2)``."""
    from zipnn_tpu_torch import entry  # noqa: PLC0415
    from zipnn_tpu_torch.ops import kernels  # noqa: PLC0415

    fn, args = entry.entry(dev)
    kernels.reset_launches()
    (out, bits_left), ms = host_ms(lambda: fn(*args))
    check(kernels.launches["huf_pc_decode"] == 1 and kernels.launches["combine_cells"] == 1,
          "entry's step did not launch K1 then K2 once each")
    check(int(bits_left.abs().sum()) == 0 and np.array_equal(
        out.cpu().numpy(), entry.synth_bf16(entry.N_CHUNKS * entry.CHUNK)),
        "entry's step is not bit-exact")
    log(f"[entry] entry(): one K1 + one K2 on {out.device}, {ms:.3f} ms, bit-exact")
    entry.dryrun_multichip(2)


def multi_device(file, x_bf16, x_fp32, goldens: dict, dev, smi) -> dict:
    """Phase 14: a (the mesh's paths and their kernels at a shard's
    shapes), b (two processes) and c (the entry module); returns 14a's
    launches and held kernels for the ``kernels`` line."""
    t0 = time.perf_counter()
    launches = mesh_paths(x_bf16, x_fp32, goldens, dev, smi)
    held = mesh_holds(x_bf16, x_fp32, goldens, dev)
    t_a = time.perf_counter()
    two_ranks(file, dev, smi)
    t_b = time.perf_counter()
    entry_phase(dev)
    wall = time.perf_counter() - t0
    log(f"[phase 14] {wall:.2f} s (a {t_a - t0:.2f}, b {t_b - t_a:.2f}, "
        f"c {time.perf_counter() - t_b:.2f})")
    return {"launches": launches, "held": held}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=512)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, str(ROOT))
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
    from zipnn_tpu_torch.ops import decode, huf_pc, huf_shared, kernels  # noqa: PLC0415

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    host_cpu = cpu_model()
    log(f"host CPU: {host_cpu}")

    # ---- 1. build -------------------------------------------------------
    from zipnn_tpu_torch import native  # noqa: PLC0415

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        core = pool.submit(native.lib)  # g++ beside the nvcc processes
        kernels.lib()
        core.result()
    log(f"[build] {len(kernels._sources())} kernel sources and the native host core built "
        f"and loaded in {time.perf_counter() - t0:.2f} s (g++ "
        + ("not run: built before" if native.build_seconds is None
           else f"{native.build_seconds:.2f} s") + f", {native.build().name})")
    for line in kernels.build_log().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log("[build]", line.strip())

    # ---- the three paths' containers --------------------------------------
    mib = args.mib << 20
    x_bf16 = synth(torch.bfloat16, mib + TAIL_BF16, args.seed)
    x_fp32 = synth(torch.float32, mib + TAIL_FP32, args.seed)
    c_bf16 = compressed(kernels.BUILD_DIR, "bf16", x_bf16, "per_chunk")
    c_fp32 = compressed(kernels.BUILD_DIR, "fp32", x_fp32, "per_chunk")
    c_shared = compressed(kernels.BUILD_DIR, "bf16", x_bf16, "shared")
    c_fp32_shared = compressed(kernels.BUILD_DIR, "fp32", x_fp32, "shared")
    x_lossy = lossy_input(args.seed + 30)
    c_lossy = ZipNN(input_format="torch", engine="native",
                    lossy_compressed_type="integer").compress(x_lossy)
    check((c_lossy[5], c_lossy[6], c_lossy[12]) == (220, 0, 1),
          "the fp32 lossy container is not int32 planes without rotation")

    # ---- 2. kernels against their plain versions ------------------------
    rows = {}
    plan, dv, (lo, hi) = plan_of(c_bf16, dev)
    k1a = dv.k1_args(lo, hi)
    sym, rows["k1_bf16"] = hold_decode(
        f"huf_pc_decode (bf16, {hi - lo} chunks)", huf_pc, huf_pc.huf_pc_decode,
        huf_pc.huf_pc_decode_plain, k1a, k1_table_bytes(k1a))
    distinct = int(torch.unique(dv.tables, dim=0).shape[0])
    log(f"[kernels] the bf16 plan has {plan.n_huf} Huffman cells with "
        f"{distinct} distinct tables")
    rows["k2_2"] = hold_combine("combine_cells (2 planes)", plan,
                                dv.k2_args(lo, hi, sym), x_bf16, lo, hi)
    del dv, sym

    plan, dv, (lo, hi) = plan_of(c_fp32, dev)
    check(plan.g.num_buf == 4 and not plan.shared, "fp32 plan")
    k1a = dv.k1_args(lo, hi)
    sym, rows["k1_fp32"] = hold_decode(
        f"huf_pc_decode (fp32, {hi - lo} chunks)", huf_pc, huf_pc.huf_pc_decode,
        huf_pc.huf_pc_decode_plain, k1a, k1_table_bytes(k1a))
    kinds = np.bincount(plan.g.kind[:, lo:hi].reshape(-1), minlength=3)
    log(f"[kernels] fp32 first batch cells: {kinds[0]} stored, {kinds[1]} RLE, "
        f"{kinds[2]} Huffman")
    check(kinds[decode.KIND_STORED] > 0, "fp32 batch has no stored cells")
    rows["k2_4"] = hold_combine("combine_cells (4 planes)", plan,
                                dv.k2_args(lo, hi, sym), x_fp32, lo, hi)
    del dv, sym, k1a

    plan, dv, (lo, hi) = plan_of(c_shared, dev)
    check(plan.shared, "the shared-table container does not take the shared plan")
    _, rows["k6"] = hold_decode(
        f"huf_shared_decode (bf16 shared, {hi - lo} chunks)", huf_shared,
        huf_shared.huf_shared_decode, huf_shared.huf_shared_decode_plain,
        dv.k6_args(lo, hi), 512)
    del dv
    rows["k8"], rows["k7"] = hold_encode_kernels(x_bf16, dev)
    rows["hist"], rows["k7pc"], batch = hold_pc_encode_kernels(x_bf16, dev)
    hold_native(batch, c_bf16)
    del batch
    spl = hold_splice(x_bf16, {"per_chunk": c_bf16, "shared": c_shared}, dev)
    rows["splice_pc"], rows["splice_shared"] = spl["per_chunk"], spl["shared"]
    torch.cuda.empty_cache()
    # K2 at one plane (fp8, 64 KB chunks) and into an out that is 4- but not
    # 16-byte aligned at 256 B chunks (every word by the per-word path)
    x8 = synth(torch.float8_e4m3fn, SMALL_MIB << 20, args.seed + 9)
    hold_combine_of("combine_cells (1 plane, fp8)", ZipNN(
        input_format="torch", engine="numpy", compression_chunk=64 << 10).compress(x8),
        x8, dev)
    xs = synth(torch.bfloat16, (1 << 20) + 36, args.seed + 10)
    hold_combine_of("combine_cells (2 planes, 256 B chunks, out at +4 B)", ZipNN(
        input_format="torch", engine="numpy", compression_chunk=256).compress(xs),
        xs, dev, offset=4)
    del x8, xs
    # K2 at 4 planes with no sign rotation: the lossy int32 planes
    rows["k2_4_norot"] = hold_combine_of(
        "combine_cells (4 planes, bit_reorder 0: fp32 lossy INTEGER)", c_lossy,
        (x_lossy * float(2**27)).to(torch.int32), dev)
    del c_lossy
    torch.cuda.empty_cache()

    # ---- 3. fixtures ----------------------------------------------------
    fix = ROOT / "tests" / "fixtures"
    for fx in ("bf16_gauss", "fp16_mixed", "fp8_gauss", "fp32_gauss"):
        got = ZipNN(engine="cuda").decompress((fix / f"{fx}.znn").read_bytes())
        check(bytes(got) == (fix / f"{fx}.raw").read_bytes(), fx)
        log(f"[fixtures] {fx}: bit-exact ({decode.last_timings['decoder']})")
    for i, dt in enumerate((torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                            torch.float32)):
        x = synth(dt, SMALL_MIB << 20, args.seed + 1 + i)
        comp = ZipNN(input_format="torch", engine="numpy",
                     huffman_table="shared").compress(x)
        y = ZipNN(input_format="torch", engine="cuda").decompress(comp)
        check(decode.last_timings["decoder"] == "huf_shared_decode", f"shared {dt}")
        check(torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8)), f"shared {dt}")
        encode_small(x, bytes(comp), f"shared {dt}")
        pc = bytes(ZipNN(input_format="torch", engine="numpy").compress(x))
        encode_small(x, pc, f"per-chunk {dt}", huffman_table="per_chunk")
        for profile, want in (("shared", bytes(comp)), ("per_chunk", pc)):
            got = bytes(ZipNN(input_format="torch", engine="native",
                              huffman_table=profile).compress(x))
            check(got == want, f"engine native {profile} {dt} != golden")
            y = ZipNN(input_format="torch", engine="native").decompress(got)
            check(torch.equal(y.view(torch.uint8), x.view(torch.uint8)),
                  f"engine native {profile} {dt} does not decode back")
        log(f"[fixtures] shared-table {dt} {SMALL_MIB} MiB (ratio "
            f"{len(comp) / (SMALL_MIB << 20):.4f}): bit-exact; encoded on the card "
            f"(host and CUDA tensor) == golden, decoded back bit-exact; per-chunk "
            f"(ratio {len(pc) / (SMALL_MIB << 20):.4f}) encoded on the card == golden; "
            f"engine native, both profiles, == golden and decoded back")
    uncodeable_case(args.seed + 7)
    small_chunk_case(args.seed + 8)
    sub_word_case(args.seed + 11)

    # ---- 4. the paths ---------------------------------------------------
    paths = {
        "bf16": drive("bf16 per-chunk", c_bf16, x_bf16,
                      ("huf_pc_decode", "combine_cells"), (), smi),
        "fp32": drive("fp32 per-chunk", c_fp32, x_fp32,
                      ("huf_pc_decode", "combine_cells"), (), smi),
        "shared": drive("bf16 shared", c_shared, x_bf16,
                        ("huf_shared_decode", "combine_cells"), ("huf_pc_decode",), smi),
    }

    # ---- 5. corruption --------------------------------------------------
    check(corrupt_case("per-chunk bf16", (fix / "bf16_gauss.znn").read_bytes(), 1)
          == "huf_pc_decode", "per-chunk corruption took the wrong decoder")
    small = x_bf16[: 1 << 19]  # 4 chunks of 256 KB
    c_small = ZipNN(input_format="torch", engine="numpy",
                    huffman_table="shared").compress(small)
    check(corrupt_case("shared bf16", c_small, 4 + 2) == "huf_shared_decode",
          "shared corruption took the wrong decoder")

    # ---- 6. shared-table encode at full width ----------------------------
    from zipnn_tpu_torch.ops import encode  # noqa: PLC0415

    x_dev, enc, got = encode_path("bf16 shared encode", x_bf16, c_shared,
                                  GOLDEN_S.get(("bf16", "shared")), smi)
    y = ZipNN(input_format="torch", engine="cuda").decompress(got)
    check(torch.equal(y.view(torch.int16), x_dev.view(torch.int16)),
          "the card's bf16 container does not decode back")
    del y, x_dev, got
    got, ms = host_ms(lambda: ZipNN(input_format="torch", engine="cuda",
                                    huffman_table="shared").compress(x_bf16))
    check(bytes(got) == c_shared, "bf16 shared encode from the host tensor != golden")
    log(f"[encode] bf16 shared encode from the host tensor (upload "
        f"{encode.last_timings['upload_bytes']} bytes, {encode.last_timings['upload_s']:.3f} s): "
        f"{ms / 1e3:.3f} s = {x_bf16.numel() * 2 / ms / 1e6:.3f} GB/s end to end, == golden")
    del got
    encode_path("fp32 shared encode", x_fp32, c_fp32_shared,
                GOLDEN_S.get(("fp32", "shared")), smi)
    del c_fp32_shared
    batch_chunks = encode.batch_chunks
    half = mib // 2  # 256 MiB at the default --mib 512
    encode.batch_chunks = lambda cs, stride: max(stride, half // (cs * stride) * stride)
    try:
        encode_path(f"bf16 shared encode, {half >> 20} MiB batches", x_bf16, c_shared,
                    None, smi)
        check(encode.last_timings["batches"] >= 2, "the 256 MiB batch bound gave one batch")
    finally:
        encode.batch_chunks = batch_chunks
    pc = {"bf16": pc_encode_path("bf16 per-chunk encode", x_bf16, c_bf16,
                                 GOLDEN_S.get(("bf16", "per_chunk")), smi)}
    pc["fp32"] = pc_encode_path("fp32 per-chunk encode", x_fp32, c_fp32,
                                GOLDEN_S.get(("fp32", "per_chunk")), smi)

    # ---- 7. the serving load --------------------------------------------
    names, xs, blobs, walls = serving_load(args.seed + 20, dev, smi)

    # ---- 8. the checkpoint save -------------------------------------------
    save = checkpoint_save(names, xs, dev, smi)

    # ---- 9. whole-file streaming -----------------------------------------
    file, nat = whole_file_streaming(names, xs, dev, smi)

    # ---- 10. the per-tensor .znn.safetensors load ------------------------
    per_tensor_file(names, xs, blobs, walls["iter2"], dev, smi)

    # ---- 11. delta -------------------------------------------------------
    q_base, q_tuned = delta_case(names, xs, args.seed + 40, dev, smi)
    del names, xs, blobs
    torch.cuda.empty_cache()

    # ---- 12. lossy INTEGER -----------------------------------------------
    lossy = lossy_case("fp32, int32 path", x_lossy, 27, True, dev, smi)
    lossy_case("bf16, int16 path", synth(torch.bfloat16, 32 << 20, args.seed + 31), 8, True,
               dev, smi)
    lossy_case("fp32 out of range", synth(torch.float32, 8 << 20, args.seed + 32) * 1e30, 27,
               False, dev, smi)
    del x_lossy

    # ---- 13. the CLI and a trace on the card -------------------------------
    cli = cli_and_trace(file, nat, q_base, q_tuned, bytes(c_bf16), x_bf16,
                        {k: r["ms"] for k, r in rows.items()}, dev, smi)
    del nat, q_base, q_tuned
    torch.cuda.empty_cache()

    # ---- 14. several shards and several processes --------------------------
    mesh = multi_device(file, x_bf16, x_fp32,
                        {"bf16": bytes(c_bf16), "shared": c_shared, "fp32": c_fp32}, dev, smi)
    del file, c_bf16, c_shared, c_fp32, x_fp32

    # ---- summary ---------------------------------------------------------
    # phase 13: each row's launches in the CLI's counted run of its path
    # (a: compress_file, decompress_file, --huffman_table shared; null
    # where the CLI runs another path), its time at the CLI's shapes (a's
    # held kernels) and its largest time in the profiler's trace (d)
    cli_run = {"k1_bf16": "decompress", "k2_2": "decompress", "k6": "shared_decompress",
               "k8": "shared", "k7": "shared", "hist": "compress", "k7pc": "compress",
               "splice_pc": "compress", "splice_shared": "shared"}

    # phase 14a: each row's launches in the 2-shard mesh's counted run of its
    # path (null where 14a does not run it) and its time at one shard's batch
    mesh_run = {"k1_bf16": "bf16 per-chunk:decode", "k2_2": "bf16 per-chunk:decode",
                "k1_fp32": "fp32 per-chunk:decode", "k2_4": "fp32 per-chunk:decode",
                "k6": "bf16 shared:decode", "k8": "bf16 shared:encode",
                "k7": "bf16 shared:encode", "splice_shared": "bf16 shared:encode",
                "hist": "bf16 per-chunk:encode", "k7pc": "bf16 per-chunk:encode",
                "splice_pc": "bf16 per-chunk:encode"}

    def row(key, kname, source, replaces, path, launches):
        run = cli_run.get(key)
        held = cli["held"].get(key)
        mrun = mesh_run.get(key)
        return {"name": kname, "path": path, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "bound_by": "bytes",
                "library_ms": None, **rows[key],
                "cli_launches": cli["launches"][run][kname] if run else None,
                "cli_ms": held["ms"] if held else None,
                "cli_bound_ms": held["bound_ms"] if held else None,
                "profiler_ms": cli["profiler_ms"].get(key),
                "mesh_launches": mesh["launches"][mrun][kname] if mrun else None,
                "mesh_ms": mesh["held"][key]["ms"] if mrun else None,
                "mesh_bound_ms": mesh["held"][key]["bound_ms"] if mrun else None}

    k1 = "zipnn_tpu/ops/pallas_huf_pc.py:425 (K1); zipnn_tpu/ops/pallas_gather.py:84 (K3)"
    k2 = "zipnn_tpu/ops/pallas_combine.py:249 (K2)"
    out = [
        row("k1_bf16", "huf_pc_decode", "zipnn_tpu_torch/csrc/huf_pc.cu", k1,
            "bf16 per-chunk", paths["bf16"]["huf_pc_decode"]),
        row("k1_fp32", "huf_pc_decode", "zipnn_tpu_torch/csrc/huf_pc.cu",
            k1 + "; zipnn_tpu/ops/pallas_huf_pc.py:540 (K4)",
            "fp32 per-chunk", paths["fp32"]["huf_pc_decode"]),
        row("k6", "huf_shared_decode", "zipnn_tpu_torch/csrc/huf_shared.cu",
            "zipnn_tpu/ops/pallas_huf.py:239 (K6); zipnn_tpu/ops/pallas_gather.py:84 (K3)",
            "bf16 shared", paths["shared"]["huf_shared_decode"]),
        row("k2_2", "combine_cells", "zipnn_tpu_torch/csrc/combine.cu", k2,
            "bf16 per-chunk (2 planes)", paths["bf16"]["combine_cells"]),
        row("k2_4", "combine_cells", "zipnn_tpu_torch/csrc/combine.cu",
            k2 + "; zipnn_tpu/ops/pallas_gather.py:172 (K5)",
            "fp32 per-chunk (4 planes)", paths["fp32"]["combine_cells"]),
        row("k2_4_norot", "combine_cells", "zipnn_tpu_torch/csrc/combine.cu", k2,
            "fp32 lossy INTEGER (4 planes, no sign rotation)", lossy["combine_cells"]),
        row("k8", "const_scan_rows", "zipnn_tpu_torch/csrc/const_scan.cu",
            "zipnn_tpu/ops/pallas_gather.py:238 (K8)", "bf16 shared encode",
            enc["const_scan_rows"]),
        row("k7", "huf_shared_encode", "zipnn_tpu_torch/csrc/huf_enc.cu",
            "zipnn_tpu/ops/pallas_huf_enc.py:225 (K7)", "bf16 shared encode",
            enc["huf_shared_encode"]),
        row("hist", "hist_cells", "zipnn_tpu_torch/csrc/hist.cu",
            "zipnn_tpu/ops/jax_entropy.py:139 histogram_cells (XLA device code, not a "
            "pl.pallas_call site)", "bf16 per-chunk encode", pc["bf16"]["hist_cells"]),
        row("k7pc", "huf_pc_encode", "zipnn_tpu_torch/csrc/huf_enc.cu",
            "zipnn_tpu/ops/jax_entropy.py:89 encode_streams (XLA device code, not a "
            "pl.pallas_call site)", "bf16 per-chunk encode", pc["bf16"]["huf_pc_encode"]),
    ]
    asm = ("zipnn_tpu/ops/jax_codec.py:1004-1280 _assemble (host code, no device kernel and "
           "no pl.pallas_call site)")
    for key, profile in (("splice_pc", "per_chunk"), ("splice_shared", "shared")):
        out.append(row(key, "splice_cells", "zipnn_tpu_torch/csrc/splice.cu", asm,
                       f"Llama-3-8B checkpoint save, {profile}",
                       save[profile]["splice_cells"]))
    for r in out:
        log(f"[summary] {r['name']} ({r['path']}): {r['launches']} launches, "
            f"{r['ms']:.3f} ms vs bound {r['bound_ms']:.4f} ms, plain match; "
            f"replaces {r['replaces']}")
    log(json.dumps({"kernels": out}))
    log(f"host CPU: {host_cpu}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
