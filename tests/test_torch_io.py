"""PyTorch port: the loaders on the CPU, held against the JAX package.

* ``io.serving.ShardDecoder`` on streaming containers (the frames decoded
  as one container, also staged and in ``decompress_all`` beside ordinary
  containers) and on lossy containers (the float bytes, as ``ZipNN``
  decodes them), and its refusals: delta, whole-buffer method and
  tensor-format streaming containers;
* ``io.streaming.SafetensorsStreamReader`` on files the JAX package's
  plugin writes (compressed bf16/fp32/fp16/fp8, raw ints), by tensor, by
  host share and whole, onto the requested device;
* ``io.pytree.save_pytree`` / ``load_pytree`` both ways across the
  packages, with and without ``like``, and the per-leaf ``devices``.

Everything decodes with ``device="cpu"`` / ``decode_device="cpu"`` (the
kernels' plain versions).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

import zipnn_tpu
from zipnn_tpu.io import load_pytree as ref_load_pytree
from zipnn_tpu.io import save_pytree as ref_save_pytree
from zipnn_tpu.plugins.safetensors import compress_tensor as ref_compress_tensor
from zipnn_tpu.plugins.safetensors import set_compressed_tensors_metadata
from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.io import (
    SafetensorsStreamReader, ShardDecoder, leaf_paths, load_pytree, partition_names,
    save_pytree,
)
from zipnn_tpu_torch.ops import decode

CHUNK = 16384


def _bf16(n_bytes, seed):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(n_bytes // 2 + 1) * 0.05).astype(np.float32)
    return ((vals.view(np.uint32) >> 16).astype("<u2")).tobytes()[:n_bytes]


def _dec(**kw):
    return ShardDecoder(device="cpu", **kw)


def _stream(data, streaming_chunk=32768):
    return bytes(zipnn_tpu.ZipNN(engine="numpy", is_streaming=True, compression_chunk=CHUNK,
                                 streaming_chunk=streaming_chunk).compress(data))


def test_shard_decoder_streaming_and_lossy():
    data = _bf16(200_001, seed=1)
    stream = _stream(data)
    plain = bytes(zipnn_tpu.ZipNN(engine="numpy", compression_chunk=CHUNK).compress(data))
    g = torch.Generator().manual_seed(2)
    t = torch.randn(80, 64, generator=g) * 0.05
    lossy = bytes(zipnn_tpu.ZipNN(engine="numpy", input_format="torch", compression_chunk=CHUNK,
                                  lossy_compressed_type="integer").compress(t))
    lossy_want = ZipNN(engine="cuda", device="cpu").decompress(lossy)
    assert torch.equal(lossy_want, zipnn_tpu.ZipNN(input_format="torch").decompress(lossy))
    wants = [data, lossy_want.view(torch.uint8).reshape(-1).numpy().tobytes(), data]
    blobs = [stream, lossy, plain]
    assert list(_dec().decompress_iter(blobs)) == wants
    assert decode.last_timings["plan_s"] >= 0
    dev = _dec(to_device=True)
    got = dev.decompress_all([dev.stage(stream), dev.stage(lossy), plain])
    assert [bytes(x.numpy()) for x in got] == wants
    assert dev.stage(stream).staged.plan.g.n_chunks == -(-len(data) // CHUNK)


def test_shard_decoder_refusals():
    data = _bf16(100_000, seed=3)
    delta = bytes(zipnn_tpu.ZipNN(engine="numpy", delta_compressed_type="byte")
                  .compress(data, delta_second_data=data))
    vanilla = bytes(zipnn_tpu.ZipNN(engine="numpy", method="zstd", byte_reorder=0b0_00_01_001)
                    .compress(data))
    tensor = bytearray(zipnn_tpu.ZipNN(engine="numpy", input_format="torch").compress(
        torch.randn(64, 64)))
    tensor[13] = 128 + 20  # a streaming marker on a tensor-format frame
    for blob, match in ((delta, "delta"), (vanilla, "ZipNN.decompress"),
                        (bytes(tensor), "tensor input format")):
        with pytest.raises(ValueError, match=match):
            _dec().decompress(blob)
    assert bytes(ZipNN(engine="cuda", device="cpu", method="zstd").decompress(vanilla)) == data


def _st_file(path, seed=9):
    """A safetensors file the JAX package's plugin writes: compressed float
    tensors, a raw int tensor; returns the originals."""
    g = torch.Generator().manual_seed(seed)
    tensors = {
        "big": torch.randn(300, 256, generator=g).to(torch.bfloat16),
        "mid": torch.randn(100, 90, generator=g),
        "half": torch.randn(64, 33, generator=g).to(torch.float16),
        "fp8": (torch.randn(96, 64, generator=g) * 0.1).to(torch.float8_e4m3fn),
        "small": torch.arange(64, dtype=torch.int64),
    }
    out, infos = {}, {}
    for name, t in tensors.items():
        res = ref_compress_tensor(t) if t.is_floating_point() else None
        if res is None:
            out[name] = t
        else:
            out[name], infos[name] = res
    md = {"format": "pt"}
    set_compressed_tensors_metadata(infos, md)
    save_file(out, path, metadata=md)
    return tensors, infos


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def test_stream_reader_reads_reference_files(tmp_path):
    path = str(tmp_path / "m.znn.safetensors")
    tensors, infos = _st_file(path)
    assert {"big", "mid", "half", "fp8"} <= set(infos)
    with SafetensorsStreamReader(path, decode_device="cpu") as r:
        assert set(r.keys()) == set(tensors) and set(r.compressed) == set(infos)
        for name, want in tensors.items():
            got = r.get_tensor(name)
            assert got.device.type == "cpu" and _same(got, want), name
        seen = {}
        for h in range(3):
            seen.update(r.load_shard(n_hosts=3, host_id=h, device="cpu"))
        assert seen.keys() == tensors.keys()
        assert all(_same(seen[n], t) for n, t in tensors.items())


def test_partitioning_covers_exactly_once():
    entries = [(f"t{i}", (i * 37) % 91 + 1) for i in range(23)]
    shards = [partition_names(entries, 4, h) for h in range(4)]
    assert sorted(x for s in shards for x in s) == sorted(e[0] for e in entries)
    loads = [sum(dict(entries)[x] for x in s) for s in shards]
    assert max(loads) <= 2 * max(min(loads), 1)
    from zipnn_tpu.io import partition_names as ref_partition

    assert shards == [ref_partition(entries, 4, h) for h in range(4)]
    with pytest.raises(ValueError):
        partition_names(entries, 2, 2)


Pair = collections.namedtuple("Pair", ["first", "second"])


def _torch_tree(seed=31):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "dense": {"kernel": (torch.randn(256, 128, generator=g) * 0.05).to(torch.bfloat16),
                      "bias": torch.zeros(128)},
            "emb": torch.randn(64, 32, generator=g) * 0.01,
        },
        "step": torch.tensor([7], dtype=torch.int32),
        "layers": [torch.randn(40, 16, generator=g), torch.randn(8, generator=g)],
        "pair": Pair(torch.ones(4, dtype=torch.float16), torch.full((3,), 2.0)),
        "noise": torch.randint(-2**15, 2**15, (32, 64), generator=g, dtype=torch.int16)
        .view(torch.bfloat16),  # incompressible: stored raw
    }


def test_save_pytree_loads_in_the_jax_package(tmp_path):
    tree = _torch_tree()
    path = str(tmp_path / "ckpt.znn.safetensors")
    compressed = save_pytree(path, tree, device="cpu")
    assert compressed["params/dense/kernel"] and not compressed["step"]
    assert not compressed["noise"]
    assert set(compressed) == set(leaf_paths(tree))
    ref = ref_load_pytree(path)
    flat = leaf_paths(tree)
    for name, want in flat.items():
        node = ref
        for part in name.split("/"):
            node = node[part]
        got = np.ascontiguousarray(np.asarray(node)).view(np.uint8)
        assert got.tobytes() == want.reshape(-1).view(torch.uint8).numpy().tobytes(), name
    back = load_pytree(path, like=tree, decode_device="cpu")
    assert type(back["pair"]) is Pair and isinstance(back["layers"], list)
    assert all(_same(a, b) for a, b in zip(leaf_paths(back).values(), flat.values()))


def test_load_pytree_reads_jax_package_files(tmp_path):
    rng = np.random.default_rng(5)
    jtree = {
        "a": {"w": jnp.asarray((rng.standard_normal((64, 48)) * 0.05).astype(np.float32))
              .astype(jnp.bfloat16)},
        "b": [jnp.asarray(rng.standard_normal(100).astype(np.float32)),
              jnp.arange(5, dtype=jnp.int32)],
    }
    path = str(tmp_path / "jax.znn.safetensors")
    ref_save_pytree(path, jtree)
    nested = load_pytree(path, decode_device="cpu")
    assert set(nested) == {"a", "b"} and set(nested["b"]) == {"0", "1"}
    with pytest.raises(KeyError, match="a/z"):
        load_pytree(path, like={"a": {"w": 0, "z": 0}, "b": [0, 0]}, decode_device="cpu")
    with pytest.raises(ValueError, match="extra leaves"):
        load_pytree(path, like={"a": {"w": 0}}, decode_device="cpu")
    like = {"a": {"w": 0}, "b": [0, 0]}
    back = load_pytree(path, like=like, decode_device="cpu",
                       devices={"b/1": torch.device("cpu")})
    jflat = dict(zip(
        ("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
         for kp, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]),
        jax.tree_util.tree_leaves(jtree)))
    assert leaf_paths(back).keys() == jflat.keys()
    for name, leaf in leaf_paths(back).items():
        want = np.asarray(jflat[name])
        got = leaf.view(torch.uint16).numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
        assert got.tobytes() == want.tobytes(), name
    single = load_pytree(path, decode_device="cpu", devices=lambda name: "cpu")
    assert single["a"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="separator"):
        leaf_paths({"a/b": torch.zeros(1)})
