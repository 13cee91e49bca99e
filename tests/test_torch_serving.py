"""PyTorch port: ``zipnn_tpu_torch.io.serving.ShardDecoder`` on the CPU
(``device="cpu"``, the kernels' plain versions) against the JAX package's
``zipnn_tpu.io.serving.ShardDecoder`` on the same containers, bit-exact:

* order and bytes through ``decompress_iter``, ``decompress`` and
  ``decompress_all`` (3 bf16 shards of ~300 KB, made as
  ``tests/test_serving.py`` makes them), and through a twice-replayed
  ``decompress_groups`` and ``decompress_stacked`` of staged shards (3 of
  ~60 KB at 16 KB chunks);
* mixed containers: one with no full chunk, a shared-table one, an fp32
  one; torch- and numpy-format frames decode flat;
* ``as_numpy`` yields owned, writable arrays; ``to_device`` yields uint8
  tensors on the device;
* errors: bad magic and delta raise ``ValueError`` (a streaming container
  decodes, as the reference's does); ``decompress_all`` / ``decompress_groups``
  refuse without ``to_device`` / ``as_numpy``; a flipped bit in shard 2 of
  3 under ``decompress_all`` raises the ``CorruptChunkError`` that shard's
  own ``ZipNN.decompress`` raises.
"""
import numpy as np
import pytest
import torch

import zipnn_tpu
from zipnn_tpu.io.serving import ShardDecoder as RefShardDecoder
from zipnn_tpu_torch import CorruptChunkError, ZipNN
from zipnn_tpu_torch.io import serving
from zipnn_tpu_torch.io.serving import ShardDecoder
from zipnn_tpu_torch.ops import decode


def _bf16(n_bytes, seed=3):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(n_bytes // 2) * 0.05).astype(np.float32)
    return ((vals.view(np.uint32) >> 16).astype("<u2")).tobytes()[:n_bytes]


def _shards(k=3, size=300_000, **kw):
    outs, blobs = [], []
    for i in range(k):
        data = _bf16(size + i * 7, seed=10 + i)
        outs.append(data)
        blobs.append(bytes(zipnn_tpu.ZipNN(engine="numpy", **kw).compress(data)))
    return outs, blobs


# 16 KB chunks keep the plain decoders' lockstep loops short (~0.03 s a
# shard where a 300 KB shard at 256 KB chunks takes ~0.4 s)
SMALL = {"size": 60_000, "compression_chunk": 16384}


@pytest.fixture(scope="module")
def shards():
    outs, blobs = _shards()
    ref = [bytes(g) for g in RefShardDecoder().decompress_iter(blobs)]
    assert ref == outs
    return outs, blobs


def _dec(**kw):
    return ShardDecoder(device="cpu", **kw)


def test_iter_and_single_match_reference(shards):
    outs, blobs = shards
    dec = _dec()
    got = list(dec.decompress_iter(blobs))
    assert all(isinstance(g, bytes) for g in got) and got == outs
    assert [t["decoder"] for t in dec.timings] == ["huf_pc_decode"] * 3
    assert list(serving.decompress_iter(blobs[:1], device="cpu")) == outs[:1]
    assert dec.decompress(blobs[1]) == outs[1]


def test_decompress_all_mixes_blobs_and_staged(shards):
    outs, blobs = shards
    dec = _dec(as_numpy=True)
    staged = dec.stage(blobs[1])
    assert staged.upload_bytes > 0
    assert [g.tobytes() for g in dec.decompress_all([blobs[0], staged, blobs[2]])] == outs


def test_replayed_groups_and_stacked_small_shards():
    outs, blobs = _shards(**SMALL)
    dec = _dec(to_device=True)
    staged = [dec.stage(b) for b in blobs]
    units = dec.stack_groups(staged)
    assert [u[0] for u in units] == ["stk", "n"]
    for _ in range(2):  # a staged plan replays
        assert [g.numpy().tobytes() for g in dec.decompress_groups(units)] == outs
    assert [g.numpy().tobytes() for g in dec.decompress_stacked(staged)] == outs
    assert [g.numpy().tobytes() for g in dec.decompress_stacked(dec.stack(staged[1:]))] == outs[1:]
    assert dec.stack([staged[0], blobs[1]]) is None
    assert dec.decompress_stacked([staged[0], blobs[1]]) is None
    assert dec.start_staged(staged[2]).finish().numpy().tobytes() == outs[2]
    assert [u[0] for u in dec.stack_groups([blobs[0], staged[1], blobs[2]])] == ["one"] * 3 + ["n"]


def test_mixed_containers_in_one_load():
    """No full chunk (an 8 KB norm weight), the shared-table profile, fp32
    and a torch-format frame, in one load, in order, equal to the
    originals."""
    rng = np.random.default_rng(4)
    f32 = (rng.standard_normal(40_000) * 0.02).astype(np.float32)
    t = torch.from_numpy((rng.standard_normal((129, 257)) * 0.03).astype(np.float32))
    raws = [_bf16(8192, seed=1), _bf16(50_000, seed=2), f32.tobytes(),
            t.numpy().tobytes(), _bf16(60_003, seed=5)]
    kw = {"engine": "numpy", "compression_chunk": 16384}
    blobs = [
        bytes(zipnn_tpu.ZipNN(engine="numpy").compress(raws[0])),
        bytes(zipnn_tpu.ZipNN(huffman_table="shared", **kw).compress(raws[1])),
        bytes(zipnn_tpu.ZipNN(bytearray_dtype="float32", **kw).compress(raws[2])),
        bytes(zipnn_tpu.ZipNN(input_format="torch", **kw).compress(t)),
        bytes(ZipNN(device="cpu", **kw).compress(raws[4])),
    ]
    # the reference's ShardDecoder compiles its JAX decode for each geometry
    # (~1 s a container on the CPU): it is held to the one with no full chunk
    assert bytes(RefShardDecoder().decompress(blobs[0])) == raws[0]
    dec = _dec()
    assert list(dec.decompress_iter(blobs, depth=3)) == raws
    assert [t["decoder"] for t in dec.timings[1:3]] == ["huf_shared_decode", "huf_pc_decode"]
    got = _dec(to_device=True).decompress_all(blobs)
    assert all(g.dtype == torch.uint8 and g.device.type == "cpu" for g in got)
    assert [g.numpy().tobytes() for g in got] == raws


def test_numpy_format_frame_decodes_flat():
    a = (np.random.default_rng(6).standard_normal((33, 65)) * 0.1).astype(np.float16)
    blob = bytes(zipnn_tpu.ZipNN(engine="numpy", input_format="numpy").compress(a))
    assert _dec().decompress(blob) == a.tobytes() == bytes(RefShardDecoder().decompress(blob))


def test_as_numpy_yields_owned_writable_arrays():
    outs, blobs = _shards(**SMALL)
    got = list(_dec(as_numpy=True).decompress_iter(blobs[:2]))
    for g, want in zip(got, outs):
        assert isinstance(g, np.ndarray) and g.dtype == np.uint8
        assert g.flags.writeable and g.flags.owndata
        assert g.tobytes() == want
    got[0][:] = 0  # the second output does not share its memory
    assert got[1].tobytes() == outs[1]


def test_errors_match_reference():
    with pytest.raises(ValueError, match="ZN"):
        _dec().decompress(b"XX" + b"\0" * 64)
    data, base = _bf16(100_000), _bf16(100_000, seed=9)
    blob = bytes(zipnn_tpu.ZipNN(engine="numpy", delta_compressed_type="byte")
                 .compress(data, delta_second_data=base))
    for dec in (_dec(), RefShardDecoder()):
        with pytest.raises(ValueError, match="delta"):
            dec.decompress(blob)
    data = _bf16(200_001, seed=7)
    stream = bytes(zipnn_tpu.ZipNN(engine="numpy", is_streaming=True,
                                   streaming_chunk=65536).compress(data))
    assert _dec().decompress(stream) == RefShardDecoder().decompress(stream) == data
    for call in ("decompress_all", "decompress_groups", "decompress_stacked"):
        with pytest.raises(ValueError, match="to_device"):
            getattr(_dec(), call)([("n", 0)] if call == "decompress_groups" else [])


def _flip_until_rejected(blob: bytes, stream: int) -> bytes:
    """A copy of ``blob`` with one bit flipped in a Huffman stream, one that
    the port's ``ZipNN.decompress`` rejects."""
    z = ZipNN(engine="cuda", device="cpu")
    after = z._retrieve_header(memoryview(blob))
    plan = decode.build_plan(memoryview(blob)[after:], 2, z._bit_reorder, z._byte_reorder,
                             z.compression_chunk, z.original_len)
    s0, ln = after + int(plan.starts[stream]), int(plan.lens[stream])
    for bit in range(8 * (ln // 2), 8 * (ln - 1)):
        bad = bytearray(blob)
        bad[s0 + bit // 8] ^= 1 << (bit % 8)
        try:
            ZipNN(engine="cuda", device="cpu").decompress(bytes(bad))
        except CorruptChunkError:
            return bytes(bad)
    pytest.fail("no rejected bit flip found")


def test_deferred_corruption_names_the_first_bad_shard():
    _, blobs = _shards(**SMALL)
    bad2 = _flip_until_rejected(blobs[1], 4 * 1 + 2)
    bad3 = _flip_until_rejected(blobs[2], 1)
    with pytest.raises(CorruptChunkError) as own:
        ZipNN(engine="cuda", device="cpu").decompress(bad2)
    for items in ([blobs[0], bad2, bad3], [blobs[0], bad2, blobs[2]]):
        with pytest.raises(CorruptChunkError) as got:
            _dec(as_numpy=True).decompress_all(items)
        assert (got.value.plane, got.value.chunk, got.value.stream) == (
            own.value.plane, own.value.chunk, own.value.stream)
        assert str(got.value) == str(own.value)
