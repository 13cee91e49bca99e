"""Compress and decompress a byte buffer of bf16 weights.

The counterpart of the JAX package's ``examples/simple_example_byte.py``:
2 000 000 bf16 values (4 MB), N(0, 0.05) from seed 0, compressed and
decompressed on the card; prints the ratio and the codec's statistics.

    python -m zipnn_tpu_torch.examples.simple_example_byte [--values N] [--device cpu]
"""
import numpy as np

from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.examples import device_of, parser, require


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--values", type=int, default=2_000_000, help="bf16 values (default 2 000 000)")
    args = ap.parse_args(argv)
    dev = device_of(args)

    rng = np.random.default_rng(0)
    vals = (rng.standard_normal(args.values) * 0.05).astype(np.float32)
    data = ((vals.view(np.uint32) >> 16).astype(np.uint16)).tobytes()  # bf16 bits

    znn = ZipNN(input_format="byte", bytearray_dtype="bfloat16", device=dev)
    compressed = bytes(znn.compress(data))
    print(f"ratio: {len(compressed) / len(data):.4f}")
    back = ZipNN(input_format="byte", device=dev).decompress(compressed)
    require(bytes(back) == data, "the decompressed bytes differ from the input")
    print("byte roundtrip OK", znn.last_stats.as_dict())
    return {"container": compressed}


if __name__ == "__main__":
    main()
