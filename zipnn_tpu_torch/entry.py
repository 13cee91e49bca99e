"""The port's entry points: one decode step, and a multi-device dry run.

The counterpart of the JAX package's ``__graft_entry__`` module.
The flagship step of the codec is the ``.znn`` decode: the Huffman decode
kernel K1 (``huf_pc.huf_pc_decode``) feeding the byte-group assembly K2
(``combine.combine_cells``).  :func:`entry` returns that step and its
inputs on a synthetic container; :func:`dryrun_multichip` compresses and
decompresses under an n-shard mesh and holds the result against the
golden encoder.

    python -m zipnn_tpu_torch.entry [--devices N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Tuple

import numpy as np
import torch

N_CHUNKS, CHUNK = 4, 65536
NUM_BUF, BIT_REORDER, BYTE_REORDER = 2, 1, 10  # the bf16 grouping


def synth_bf16(nbytes: int) -> np.ndarray:
    """bf16-like weight bytes (N(0, 0.05), seed 7): a compressible
    exponent plane."""
    rng = np.random.default_rng(7)
    vals = (rng.standard_normal(nbytes // 2 + 1) * 0.05).astype(np.float32)
    return ((vals.view(np.uint32) >> 16).astype(np.uint16)).view(np.uint8)[:nbytes].copy()


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """``(fn, example_args)``: ``fn(*example_args)`` is one decode step on
    ``device``, K1 then K2, of a synthetic 4-chunk bf16 container with a
    Huffman table a cell; it returns the decoded bytes (uint8, the
    container's 262 144) and every stream's ``bits_left`` (all 0)."""
    from . import codec  # noqa: PLC0415
    from .ops import combine, decode, huf_pc  # noqa: PLC0415

    data = synth_bf16(N_CHUNKS * CHUNK)
    payload = codec.compress_payload_numpy(data, NUM_BUF, BIT_REORDER, BYTE_REORDER, CHUNK)
    plan = decode.build_plan(payload, NUM_BUF, BIT_REORDER, BYTE_REORDER, CHUNK, data.size)
    if plan.shared or plan.n_huf == 0:
        raise RuntimeError("entry: the synthetic container does not take K1")
    host = decode.DeviceInputs(plan, "cpu")  # the plan's arrays, as tensors
    k2 = host.k2_args(0, N_CHUNKS, None)  # all but K1's symbols and the output
    dev = torch.device(device)
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in (*host.k1_args(0, N_CHUNKS), *k2[2:]))

    def fn(payload, starts, lens, bits0, out_offs, out_lens, cells, tlogs, tables, n_out,
           kinds, srcs, row, chunk, total, num_buf, byte_reorder, bit_reorder):
        """One decode step: K1 (the Huffman streams into symbol rows), then
        K2 (the chunks from the symbols and stored cells)."""
        hsym, bits_left = huf_pc.huf_pc_decode(payload, starts, lens, bits0, out_offs,
                                               out_lens, cells, tlogs, tables, n_out)
        out = torch.empty(-(-total // 4) * 4, dtype=torch.uint8, device=payload.device)
        combine.combine_cells(payload, hsym, kinds, srcs, row, chunk, total, num_buf,
                              byte_reorder, bit_reorder, out)
        return out[:total], bits_left

    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Compress and decompress on engine ``"cuda"`` under an
    ``n_devices``-shard mesh (round-robin over the visible devices of
    ``device``'s type: one card gives every shard), check the container
    against the golden encoder's and the round trip bit for bit, and print
    and return the per-shard work of the decode at 2, 4 and ``n_devices``
    shards (Huffman streams and chunk cells a shard, which must fall with
    the shard count)."""
    from . import ZipNN, codec, parallel  # noqa: PLC0415
    from .core.header import HEADER_LEN  # noqa: PLC0415
    from .parallel import sharded  # noqa: PLC0415

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device")
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        visible = [dev]
    devices = [visible[i % len(visible)] for i in range(n_devices)]
    mesh = parallel.make_mesh(devices)

    chunk = 8192
    data = synth_bf16(4 * n_devices * chunk + 1234).tobytes()  # a ragged tail too
    want = bytes(ZipNN(engine="numpy", compression_chunk=chunk).compress(data))
    with parallel.use_mesh(mesh):
        got = bytes(ZipNN(engine="cuda", device=dev, compression_chunk=chunk).compress(data))
        if got != want:
            raise RuntimeError("dryrun_multichip: the sharded container != the golden one")
        back = ZipNN(engine="cuda", device=dev, compression_chunk=chunk).decompress(got)
        if bytes(back) != data:
            raise RuntimeError("dryrun_multichip: the sharded round trip is not bit-exact")
    print(f"dryrun_multichip OK: mesh {dict(mesh.shape)} over {sorted({str(d) for d in devices})}, "
          f"{len(data)} bytes, container {len(got)} bytes, bit-exact")

    # the decode's work per shard at 2, 4 and n shards, from its split
    n_chunks = codec.num_chunks_for(len(data), chunk)
    types, _, _ = codec.parse_tables(memoryview(got)[HEADER_LEN:], NUM_BUF, n_chunks)
    huf_chunks = (types == 1).sum(axis=0)
    table = []
    for k in sorted({2, 4, n_devices}):
        if k > n_devices or n_devices % k:
            continue
        with parallel.use_mesh(parallel.make_mesh(devices[:k])):
            parts = sharded.shards(0, n_chunks, dev)
        table.append({
            "devices": k,
            "streams_per_shard": max(4 * int(huf_chunks[a:b].sum()) for _, a, b in parts),
            "chunk_cells_per_shard": max(NUM_BUF * (b - a) for _, a, b in parts),
        })
    for a, b in zip(table, table[1:]):
        ratio = a["streams_per_shard"] / max(b["streams_per_shard"], 1)
        if ratio < 0.75 * b["devices"] / a["devices"]:
            raise RuntimeError(f"dryrun_multichip: per-shard work does not scale: {a} -> {b}")
    print("dryrun decode scaling: " + json.dumps(table))
    return {"mesh": dict(mesh.shape), "container_bytes": len(got), "scaling": table}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="shards of the dry run (default: the CUDA device count, at least 2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out, bits_left = fn(*example)
    if int(bits_left.abs().sum()) != 0 or not np.array_equal(
            out.cpu().numpy(), synth_bf16(N_CHUNKS * CHUNK)):
        raise RuntimeError("entry: the decode step is not bit-exact")
    print(f"entry OK: {tuple(out.shape)} {out.dtype} on {out.device}, bit-exact")
    n = args.devices or max(2, torch.cuda.device_count() if args.device != "cpu" else 2)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
