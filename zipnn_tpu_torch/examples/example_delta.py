"""Delta (XOR) compression of a fine-tuned checkpoint against its base.

The counterpart of the JAX package's ``examples/example_delta.py``: an fp32
base of 1 000 000 values, N(0, 0.05) from seed 0, and a fine-tune that
moves its first 1 000 values by 1e-3; the delta container beside the plain
one, both compressed on the card, and the delta decoded back on it.

    python -m zipnn_tpu_torch.examples.example_delta [--values N] [--device cpu]
"""
import numpy as np

from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.examples import device_of, parser, require


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--values", type=int, default=1_000_000, help="fp32 values (default 1 000 000)")
    args = ap.parse_args(argv)
    dev = device_of(args)

    rng = np.random.default_rng(0)
    base = (rng.standard_normal(args.values) * 0.05).astype(np.float32).tobytes()
    # a fine-tune barely moves most weights: the XOR is highly compressible
    ft = np.frombuffer(base, np.float32).copy()
    ft[:1000] += 1e-3
    ft = ft.tobytes()

    c_delta = bytes(ZipNN(delta_compressed_type="byte", device=dev)
                    .compress(ft, delta_second_data=base))
    c_plain = bytes(ZipNN(device=dev).compress(ft))
    print(f"plain ratio {len(c_plain) / len(ft):.4f}  delta ratio {len(c_delta) / len(ft):.4f}")
    back = ZipNN(delta_compressed_type="byte", device=dev).decompress(
        c_delta, delta_second_data=base)
    require(bytes(back) == ft, "the delta container does not decode to the fine-tune")
    print("delta roundtrip OK")
    return {"container": c_delta, "plain": c_plain}


if __name__ == "__main__":
    main()
