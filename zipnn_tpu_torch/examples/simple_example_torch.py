"""Compress and decompress torch tensors of every float dtype on the card.

The counterpart of the JAX package's ``examples/simple_example_torch.py``:
(1000, 1024) tensors of N(0, 0.05) from seed 0 in bf16, fp16 and fp32,
compressed from the card and decoded back onto it with the same dtype and
shape, bit-exact.

    python -m zipnn_tpu_torch.examples.simple_example_torch [--rows N] [--device cpu]
"""
import numpy as np
import torch

from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.examples import device_of, parser, require

INT_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rows", type=int, default=1000, help="rows of 1024 values (default 1000)")
    args = ap.parse_args(argv)
    dev = device_of(args)

    rng = np.random.default_rng(0)
    containers = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        w = rng.standard_normal((args.rows, 1024)).astype(np.float32) * np.float32(0.05)
        t = torch.from_numpy(w).to(dev).to(dtype)
        c = ZipNN(input_format="torch", device=dev).compress(t)
        back = ZipNN(input_format="torch", device=dev).decompress(c)
        require(back.device.type == dev.type and back.dtype == dtype and back.shape == t.shape,
                f"{dtype}: decoded as {back.dtype} {tuple(back.shape)} on {back.device}")
        ok = torch.equal(back.view(INT_VIEW[dtype]), t.view(INT_VIEW[dtype]))
        print(f"{dtype}: ratio {len(c) / (t.numel() * t.element_size()):.4f} exact={ok}")
        require(ok, f"{dtype} does not decode back bit-exact")
        containers[dtype] = bytes(c)
    print(f"torch roundtrip OK on {dev}: bf16, fp16, fp32")
    return {"containers": containers}


if __name__ == "__main__":
    main()
