"""Per-tensor compression into a safetensors file, loaded back through
``SafeOpen``.

The counterpart of the JAX package's ``examples/example_safetensors.py``:
a bf16 (256, 257) and an fp32 (64, 65) tensor, N(0, 1) from seed 0, each
compressed on the card by ``compress_tensor``; the file is written by
``io.safetensors_layout`` (no ``safetensors`` package) and read back by
``SafeOpen``, which decodes on the card, bit-exact.

    python -m zipnn_tpu_torch.examples.example_safetensors [--device cpu]
"""
import os
import tempfile

import numpy as np
import torch

from zipnn_tpu_torch.examples import device_of, parser, require
from zipnn_tpu_torch.io import safetensors_layout
from zipnn_tpu_torch.plugins.safetensors import (
    SafeOpen, compress_tensor, set_compressed_tensors_metadata,
)


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)

    rng = np.random.default_rng(0)
    tensors = {
        "w1": torch.from_numpy(rng.standard_normal((256, 257)).astype(np.float32))
        .to(torch.bfloat16).to(dev),
        "w2": torch.from_numpy(rng.standard_normal((64, 65)).astype(np.float32)).to(dev),
    }
    out, infos = {}, {}
    for name, t in tensors.items():
        res = compress_tensor(t, device=dev)
        if res is None:
            out[name] = t
        else:
            out[name], infos[name] = res
    md = {"format": "pt"}
    set_compressed_tensors_metadata(infos, md)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.znn.safetensors")
        safetensors_layout.write(path, out, md)
        with SafeOpen(path, framework="pt", device=dev, decode_device=dev) as f:
            for name, t in tensors.items():
                got = f.get_tensor(name)
                require(got.device.type == dev.type, f"{name} loaded onto {got.device}")
                require(torch.equal(got.view(torch.int16), t.view(torch.int16)),
                        f"{name} does not load back bit-exact")
        with open(path, "rb") as f:
            file = f.read()
    print("safetensors per-tensor roundtrip OK,", len(infos), "tensors compressed")
    return {"file": file}


if __name__ == "__main__":
    main()
