"""Lossy INTEGER mode: fixed-point quantization with a bounded error.

The counterpart of the JAX package's ``examples/example_lossy.py``: a
(512, 512) fp32 tensor, N(0, 1) from seed 0, on the card, compressed with
``lossy_compressed_factor`` 16 and decoded back onto the card, where the
largest error (at most 2^-16) is computed; the lossless ratio beside it.

    python -m zipnn_tpu_torch.examples.example_lossy [--device cpu]
"""
import numpy as np
import torch

from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.examples import device_of, parser, require

FACTOR = 16


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)

    t = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 512))
                         .astype(np.float32)).to(dev)
    znn = ZipNN(input_format="torch", lossy_compressed_type="integer",
                lossy_compressed_factor=FACTOR, device=dev)
    c = bytes(znn.compress(t))
    back = ZipNN(input_format="torch", device=dev).decompress(c)
    require(back.device.type == dev.type and back.shape == t.shape,
            f"decoded as {tuple(back.shape)} on {back.device}")
    err = torch.max(torch.abs(back - t)).item()  # on the card
    lossless = bytes(ZipNN(input_format="torch", device=dev).compress(t))
    print(f"lossless ratio {len(lossless) / t.numel() / 4:.4f}  "
          f"lossy ratio {len(c) / t.numel() / 4:.4f}  max err {err:.2e} <= {2**-FACTOR:.2e}")
    require(err <= 2.0 ** -FACTOR, f"max error {err} above 2^-{FACTOR}")
    print("lossy roundtrip OK")
    return {"container": c, "lossless": lossless}


if __name__ == "__main__":
    main()
