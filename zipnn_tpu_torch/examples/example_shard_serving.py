"""A multi-shard model load decoded onto the card in staged groups.

The counterpart of the JAX package's ``examples/example_shard_serving.py``.
A model load decodes many similar containers back to back; ``ShardDecoder``
stages every shard's plan and uploads (``stage``), bundles the staged
shards (``stack_groups``) and decodes the whole load onto the card with one
validation fetch (``decompress_groups``).  Four shards of ``--shard-mib``
MiB (default 8) of weight-shaped bytes from seed 0.  There is no host
branch: a shard that will not stage raises.

    python -m zipnn_tpu_torch.examples.example_shard_serving [--shard-mib N] [--device cpu]
"""
import numpy as np

from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.examples import device_of, parser, require
from zipnn_tpu_torch.io.serving import ShardDecoder


def synth_shard(rng, nbytes: int) -> bytes:
    """Weight-shaped bytes (gaussian exponents, noisy mantissas): fp16
    bits of N(0, 0.05), as the JAX example makes them."""
    w = (rng.standard_normal(nbytes // 2) * 0.05).astype(np.float32)
    return np.asarray(w, dtype=np.float16).view(np.uint8)[:nbytes].tobytes()


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--shard-mib", type=float, default=8, help="MiB a shard (default 8)")
    args = ap.parse_args(argv)
    dev = device_of(args)

    rng = np.random.default_rng(0)
    shards = [synth_shard(rng, int(args.shard_mib * (1 << 20))) for _ in range(4)]
    z = ZipNN(bytearray_dtype="bfloat16", device=dev)
    blobs = [bytes(z.compress(s)) for s in shards]
    print(f"compressed {len(blobs)} shards, "
          f"ratio {sum(map(len, blobs)) / sum(map(len, shards)):.3f}")

    dec = ShardDecoder(to_device=True, device=dev)
    staged = [dec.stage(b) for b in blobs]  # plans and every upload
    groups = dec.stack_groups(staged)
    outs = dec.decompress_groups(groups)  # launches only, one validation fetch
    for i, (out, want) in enumerate(zip(outs, shards)):
        require(out.device.type == dev.type, f"shard {i} decoded onto {out.device}")
        require(out.cpu().numpy().tobytes() == want, f"shard {i} differs")
    print(f"decoded {len(outs)} shards onto {outs[0].device} via stacked bundles: bit-exact")
    return {"containers": blobs}


if __name__ == "__main__":
    main()
