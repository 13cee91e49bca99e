"""A tensor on the card in, a tensor on the card out, in the shared-table
profile.

The counterpart of the JAX package's ``examples/simple_example_jax.py``,
whose point is a device array in and a device array out in the shared
profile: a (512, 513) bf16 CUDA tensor, N(0, 1) from seed 0 times 0.05,
compressed on the card with ``huffman_table="shared"`` at 16 KB chunks (32
full chunks and a tail) and decoded onto the card with the same dtype and
shape, bit-exact.

    python -m zipnn_tpu_torch.examples.simple_example_device [--device cpu]
"""
import numpy as np
import torch

from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.examples import device_of, parser, require


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)

    x = np.random.default_rng(0).standard_normal((512, 513)).astype(np.float32)
    x = torch.from_numpy(x).to(dev).to(torch.bfloat16) * 0.05
    znn = ZipNN(input_format="torch", huffman_table="shared", compression_chunk=16384,
                device=dev)
    c = bytes(znn.compress(x))
    back = ZipNN(input_format="torch", device=dev).decompress(c)
    require(back.device.type == dev.type, f"decoded onto {back.device}")
    require(back.dtype == x.dtype and back.shape == x.shape,
            f"decoded as {back.dtype} {tuple(back.shape)}")
    require(torch.equal(back.view(torch.int16), x.view(torch.int16)),
            "the decoded tensor differs from the input")
    print(f"device tensor roundtrip OK on {back.device}, ratio "
          f"{len(c) / (x.numel() * x.element_size()):.4f}")
    return {"container": c}


if __name__ == "__main__":
    main()
