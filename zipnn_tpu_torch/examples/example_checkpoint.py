"""A GB-scale checkpoint through the card: ratio, GB/s, bit-exactness.

The counterpart of the JAX package's ``examples/example_checkpoint.py``,
with no download: ``--file PATH`` reads a local checkpoint file, else
``--size-mb`` MiB (default 1024) of bf16-like weights are made from seed 0
(N(0, 0.02), 64 MiB pieces: the JAX example's data at every multiple of
64).  The whole buffer is compressed and decompressed with ``--engine``
(default ``cuda``: on the card), timed, and checked bit-exact; zstd -3
runs beside it where ``zstandard`` is installed.

    python -m zipnn_tpu_torch.examples.example_checkpoint [--file PATH | --size-mb N]
        [--engine cuda|native|numpy|auto] [--device cpu]
"""
import importlib.util
import time

import numpy as np

from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.examples import device_of, parser, require

PIECE = 32 * 1024 * 1024  # bf16 values a piece: 64 MiB


def synthesize(size_mb: int) -> bytes:
    """``size_mb`` MiB of bf16 bits of N(0, 0.02) from seed 0."""
    rng = np.random.default_rng(0)
    left, out = size_mb * (1 << 19), []
    while left > 0:
        vals = (rng.standard_normal(min(PIECE, left)) * 0.02).astype(np.float32)
        out.append(((vals.view(np.uint32) >> 16).astype("<u2")).tobytes())
        left -= min(PIECE, left)
    return b"".join(out)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--file", default=None, help="a local checkpoint file (no download)")
    ap.add_argument("--size-mb", type=int, default=1024,
                    help="MiB of synthetic bf16 weights without --file (default 1024)")
    ap.add_argument("--engine", default="cuda", help="cuda (default), native, numpy or auto")
    args = ap.parse_args(argv)
    dev = device_of(args)

    if args.file:
        with open(args.file, "rb") as f:
            data = f.read()
        print(f"using {args.file}")
    else:
        data = synthesize(args.size_mb)
        print(f"synthesized {args.size_mb} MiB of bf16-like weights (seed 0)")
    gb = len(data) / 1e9
    print(f"checkpoint shard: {len(data)} bytes")

    z = ZipNN(bytearray_dtype="bfloat16", engine=args.engine, device=dev)
    t0 = time.perf_counter()
    comp = z.compress(data)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ZipNN(engine=args.engine, device=dev).decompress(comp)
    t_d = time.perf_counter() - t0
    require(bytes(back) == data, "the round trip differs from the checkpoint")
    print(f"znn     : ratio {len(comp) / len(data):.4f}  compress {gb / t_c:.3f} GB/s  "
          f"decompress {gb / t_d:.3f} GB/s  bit-exact")

    if importlib.util.find_spec("zstandard") is not None:
        import zstandard as zstd  # noqa: PLC0415

        t0 = time.perf_counter()
        zc = zstd.ZstdCompressor(level=3).compress(data)
        t_zc = time.perf_counter() - t0
        t0 = time.perf_counter()
        zd = zstd.ZstdDecompressor().decompress(zc, max_output_size=len(data))
        t_zd = time.perf_counter() - t0
        require(zd == data, "zstd round trip")
        print(f"zstd -3 : ratio {len(zc) / len(data):.4f}  compress {gb / t_zc:.3f} GB/s  "
              f"decompress {gb / t_zd:.3f} GB/s")
    return {"ratio": len(comp) / len(data), "compress_s": t_c, "decompress_s": t_d}


if __name__ == "__main__":
    main()
