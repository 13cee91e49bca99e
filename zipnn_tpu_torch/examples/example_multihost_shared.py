"""Compress one weights file with several processes, in the shared profile.

The counterpart of the JAX package's
``examples/example_multihost_shared.py``.  Every process compresses only
its chunk range.  Two collectives run (gloo): the sampled per-plane byte
counts are summed, so every process builds the same shared Huffman
tables, and the cells' sizes are all-gathered for the in-place assembly.
The file equals a one-process ``ZipNN(huffman_table="shared").compress``.

One machine, 2 processes started here (each on the card, or ``--device
cpu``):

    python -m zipnn_tpu_torch.examples.example_multihost_shared [--device cpu]

With ``torchrun --nproc_per_node N -m
zipnn_tpu_torch.examples.example_multihost_shared --worker SRC OUT`` each
process takes its rank and the coordinator from torchrun's environment.
"""
import argparse
import multiprocessing
import os
import socket
import tempfile

import numpy as np

CHUNK = 4096  # small chunks: the demo file crosses the 512-chunk sampling gate


def work(src: str, out: str, device, address=None, n=None, rank=None) -> None:
    from zipnn_tpu_torch.parallel import multihost

    multihost.initialize(address, n, rank)
    multihost.compress_file_multihost(src, out, bytearray_dtype="bfloat16",
                                      compression_chunk=CHUNK, huffman_table="shared",
                                      device=device)
    multihost.decompress_file_multihost(out, out + ".dec", device=device)
    if multihost._process()[0] == 0:
        print(f"[rank 0] wrote {out} ({os.path.getsize(out)} bytes); "
              f"{ {k: round(v, 4) for k, v in multihost.last_timings.items()} }")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: each rank's card; or cpu")
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "OUT"),
                    help="run one rank of a torchrun job on SRC, writing OUT")
    args = ap.parse_args(argv)
    if args.worker:
        work(*args.worker, args.device)
        return

    from zipnn_tpu_torch import ZipNN

    rng = np.random.default_rng(1)
    vals = (rng.standard_normal(2 * 1024 * 1024) * 0.05).astype(np.float32)
    data = ((vals.view(np.uint32) >> 16).astype("<u2")).tobytes()
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "weights.bin"), os.path.join(d, "weights.bin.znn")
        with open(src, "wb") as f:
            f.write(data)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
        ctx = multiprocessing.get_context("spawn")  # a forked child cannot use CUDA
        procs = [ctx.Process(target=work, args=(src, out, args.device, address, 2, rank))
                 for rank in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        if any(p.exitcode != 0 for p in procs):
            raise SystemExit(f"a rank failed: {[p.exitcode for p in procs]}")
        want = ZipNN(engine="native", bytearray_dtype="bfloat16", compression_chunk=CHUNK,
                     huffman_table="shared").compress(data)
        got = open(out, "rb").read()
        if got != bytes(want) or open(out + ".dec", "rb").read() != data:
            raise SystemExit("the 2-process container or its decode differs")
        print(f"2-process shared-profile container: {len(got)} bytes (ratio "
              f"{len(got) / len(data):.4f}), equal to one process's, decoded bit-exact")


if __name__ == "__main__":
    main()
