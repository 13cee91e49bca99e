"""Compress and decompress with the kernels split over a device mesh.

The counterpart of the JAX package's ``examples/example_multichip.py``.
Every CUDA device of the machine is one shard (``--shards N`` repeats
them round-robin, so one card runs N shards); the container equals the
one of no mesh, and the round trip is bit-exact.

    python -m zipnn_tpu_torch.examples.example_multichip [--shards N] [--device cpu]
"""
import argparse

import numpy as np
import torch

from zipnn_tpu_torch import ZipNN, parallel


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh entries (default: every CUDA device; 2 on the CPU)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    vals = (rng.standard_normal(1_000_000) * 0.05).astype(np.float32)
    data = ((vals.view(np.uint32) >> 16).astype(np.uint16)).tobytes()

    if args.device == "cpu":
        devices = ["cpu"] * (args.shards or 2)
    else:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not cards:
            raise SystemExit("no CUDA device: pass --device cpu")
        devices = [cards[i % len(cards)] for i in range(args.shards or len(cards))]
    mesh = parallel.make_mesh(devices)
    print("mesh:", dict(mesh.shape), [str(d) for d in mesh.flat()])
    plain = ZipNN(engine="cuda", device=args.device, compression_chunk=16384).compress(data)
    with parallel.use_mesh(mesh):
        c = ZipNN(engine="cuda", device=args.device, compression_chunk=16384).compress(data)
        back = ZipNN(engine="cuda", device=args.device, compression_chunk=16384).decompress(c)
    if bytes(c) != bytes(plain) or bytes(back) != data:
        raise SystemExit("the sharded container or its round trip differs")
    print(f"sharded roundtrip OK, container == no mesh's, ratio {len(c) / len(data):.4f}")


if __name__ == "__main__":
    main()
