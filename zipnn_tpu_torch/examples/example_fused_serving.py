"""Card-resident serving: compressed bytes in, weights on the card out.

The counterpart of the JAX package's ``examples/example_fused_serving.py``.
A (1024, 2048) weight matrix, N(0, 0.05) from seed 0 cast to bf16, is
compressed in the shared-table profile at 32 KB chunks.  Only the
compressed bytes go up to the card, where ``ShardDecoder(to_device=True)``
decodes them straight into a CUDA tensor that feeds ``relu(x @ w)``.  Then
``io.pytree.save_pytree`` / ``load_pytree`` round-trip ``{"dense":
{"kernel", "bias"}}`` through one ``.znn.safetensors`` file, decoded onto
the card.

    python -m zipnn_tpu_torch.examples.example_fused_serving [--rows N] [--device cpu]
"""
import os
import tempfile

import numpy as np
import torch

from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.examples import device_of, parser, require
from zipnn_tpu_torch.io import load_pytree, save_pytree
from zipnn_tpu_torch.io.serving import ShardDecoder

CHUNK = 32768


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rows", type=int, default=1024, help="rows of the weights (default 1024)")
    args = ap.parse_args(argv)
    dev = device_of(args)

    # offline: compress a checkpoint with the shared-table profile
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((args.rows, 2048)) * 0.05).astype(np.float32)
    weights = torch.from_numpy(w).to(torch.bfloat16)
    raw = weights.view(torch.uint16).numpy().tobytes()
    compressed = bytes(ZipNN(huffman_table="shared", compression_chunk=CHUNK, device=dev)
                       .compress(raw))
    print(f"checkpoint: {len(raw)} B -> {len(compressed)} B ({len(compressed) / len(raw):.3f})")

    # serving: the compressed bytes up once, decoded into a tensor on the card
    flat = ShardDecoder(to_device=True, device=dev).decompress(compressed)
    restored = flat.view(torch.bfloat16).reshape(weights.shape)
    require(restored.device.type == dev.type, f"decoded onto {restored.device}")
    require(torch.equal(restored.view(torch.int16), weights.to(dev).view(torch.int16)),
            "the decoded weights differ")
    print("decoded on the card:", tuple(flat.shape), "->", tuple(restored.shape), restored.device)

    # the weights feed a model step where they lie
    x = torch.from_numpy(rng.standard_normal((8, args.rows)).astype(np.float32))
    x = x.to(dev).to(torch.bfloat16)
    y = torch.relu(x @ restored)
    print("forward OK:", tuple(y.shape), y.dtype, y.device)

    # whole-model flow: one per-tensor .znn.safetensors file
    params = {"dense": {"kernel": restored,
                        "bias": torch.zeros(2048, dtype=torch.float32, device=dev)}}
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "serving_ckpt.znn.safetensors")
        compressed_leaves = save_pytree(ckpt, params, huffman_table="shared", device=dev)
        params2 = load_pytree(ckpt, like=params, decode_device=dev)
        size = os.path.getsize(ckpt)
    kernel2 = params2["dense"]["kernel"]
    require(kernel2.device.type == dev.type and kernel2.dtype == torch.bfloat16,
            f"kernel loaded as {kernel2.dtype} on {kernel2.device}")
    require(torch.equal(kernel2.view(torch.int16), restored.view(torch.int16)),
            "the checkpoint's kernel differs")
    require(torch.equal(params2["dense"]["bias"].cpu(), params["dense"]["bias"].cpu()),
            "the checkpoint's bias differs")
    y2 = torch.relu(x @ kernel2)
    print(f"pytree checkpoint roundtrip OK: {size} bytes, compressed leaves "
          f"{compressed_leaves}, forward {tuple(y2.shape)}")
    return {"container": compressed}


if __name__ == "__main__":
    main()
