"""Compress a safetensors file tensor by tensor with several processes.

The counterpart of the JAX package's
``examples/example_multihost_safetensors.py``.  Each process compresses
only its (size-balanced, deterministic) share of the tensors and writes
them into one ``.znn.safetensors`` file; one all-gather (2 integers a
tensor, gloo) is the only communication.  The file equals a one-process
run and loads through ``SafetensorsStreamReader`` (and ``SafeOpen``).

One machine, 2 processes started here (each on the card, or ``--device
cpu``):

    python -m zipnn_tpu_torch.examples.example_multihost_safetensors [--device cpu]
"""
import argparse
import json
import multiprocessing
import os
import socket
import tempfile

import torch

ST_DTYPES = {torch.bfloat16: "BF16", torch.float32: "F32", torch.int64: "I64"}


def write_safetensors(path: str, tensors: dict) -> None:
    """The safetensors layout, written directly (no ``safetensors``
    package needed): 8-byte header length, JSON header, data."""
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hjson = json.dumps(header).encode()
    hjson += b" " * ((-len(hjson)) % 8)
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little") + hjson + b"".join(blobs))


def work(src: str, out: str, device, address, n, rank) -> None:
    from zipnn_tpu_torch.parallel import multihost

    multihost.initialize(address, n, rank)
    multihost.compress_safetensors_multihost(src, out, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: each rank's card; or cpu")
    args = ap.parse_args(argv)

    from zipnn_tpu_torch.io.streaming import SafetensorsStreamReader
    from zipnn_tpu_torch.parallel import multihost

    g = torch.Generator().manual_seed(1)
    tensors = {
        "w1": (torch.randn(512, 768, generator=g) * 0.05).to(torch.bfloat16),
        "w2": (torch.randn(768, 512, generator=g) * 0.02).to(torch.bfloat16),
        "bias": torch.zeros(768),
        "steps": torch.arange(10, dtype=torch.int64),
    }
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "model.safetensors")
        out2, out1 = (os.path.join(d, f"model{k}.znn.safetensors") for k in (2, 1))
        write_safetensors(src, tensors)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
        ctx = multiprocessing.get_context("spawn")  # a forked child cannot use CUDA
        procs = [ctx.Process(target=work, args=(src, out2, args.device, address, 2, rank))
                 for rank in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        if any(p.exitcode != 0 for p in procs):
            raise SystemExit(f"a rank failed: {[p.exitcode for p in procs]}")
        multihost.compress_safetensors_multihost(src, out1, device=args.device)
        if open(out1, "rb").read() != open(out2, "rb").read():
            raise SystemExit("the 2-process file differs from the one-process one")
        rdr = SafetensorsStreamReader(out2, decode_device=args.device or "cuda")
        for name, want in tensors.items():
            got = rdr.get_tensor(name)
            if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
                raise SystemExit(f"{name} does not load back bit-exact")
            print(f"{name}: {tuple(got.shape)} {got.dtype}, "
                  f"{'compressed' if name in rdr.compressed else 'raw'}")
        print("sizes:", os.path.getsize(src), "->", os.path.getsize(out2),
              "(equal to one process's file)")


if __name__ == "__main__":
    main()
