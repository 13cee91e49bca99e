"""PyTorch port: ``zipnn_tpu_torch.io.serving.ShardEncoder`` on the CPU
(``device="cpu"``, the kernels' plain versions), its containers held byte
for byte against the port's ``ZipNN.compress`` and the JAX package's
``ShardEncoder``:

* order and bytes through ``compress_iter``, ``compress_all`` and
  ``compress``, in the default (shared) profile, the per-chunk profile and
  a numpy-engine ``zipnn``, with mixed sizes (containers with no full
  chunk between full ones), decoded back through ``ShardDecoder``;
* the same seeded inputs give the JAX package's ``ShardEncoder``
  containers;
* ``pool_staging``: memoryviews into pooled buffers, the pool bounded and
  nothing leaked; ``compress_all`` returns owned ``bytes`` even when more
  containers than the validity window pass through the pool;
* an early exit or an error in ``compress_iter`` returns every held
  buffer to the pool;
* a ``staged_words`` iterable shorter than the buffers, or with None
  entries, leaves those buffers to the encoder's own upload;
* the port's ``ZipNN`` has no delta knob yet, so ``ShardEncoder`` has no
  delta path to get wrong.
"""
import numpy as np
import pytest
import torch

import zipnn_tpu
from zipnn_tpu.io.serving import ShardEncoder as RefShardEncoder
from zipnn_tpu_torch import ZipNN
from zipnn_tpu_torch.io import serving
from zipnn_tpu_torch.io.serving import ShardDecoder, ShardEncoder

CHUNK = 16384


def _bf16(n_bytes, seed):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(n_bytes // 2) * 0.05).astype(np.float32)
    return ((vals.view(np.uint32) >> 16).astype("<u2")).tobytes()[:n_bytes]


def _bufs(k=3, size=60_000):
    return [_bf16(size + i * 13, seed=40 + i) for i in range(k)]


def _z(**kw):
    kw.setdefault("engine", "cuda")
    if kw["engine"] == "cuda":
        kw.setdefault("device", "cpu")
    return ZipNN(compression_chunk=CHUNK, **kw)


@pytest.fixture
def out_pool(monkeypatch):
    """A fresh, empty output pool for the test."""
    monkeypatch.setattr(serving, "_out_pool", [])
    return serving


@pytest.mark.parametrize("profile", ["shared", "per_chunk"])
def test_encoder_matches_zipnn_and_keeps_order(profile):
    bufs = _bufs(k=4)
    z = _z(huffman_table=profile)
    enc = ShardEncoder(zipnn=_z(huffman_table=profile))
    outs = enc.compress_all(bufs)
    want = [z.compress(b) for b in bufs]
    assert all(isinstance(o, bytes) for o in outs) and outs == want
    assert [t["encoder"] for t in enc.timings] == [
        "huf_shared_encode" if profile == "shared" else "huf_pc_encode"] * 4
    assert [bytes(g) for g in ShardDecoder(device="cpu").decompress_iter(outs)] == bufs
    assert enc.compress(bufs[1]) == want[1]


def test_encoder_default_is_the_shared_cuda_profile():
    bufs = _bufs(k=2)
    outs = ShardEncoder(device="cpu").compress_all(bufs)
    z = ZipNN(engine="cuda", huffman_table="shared", device="cpu")
    assert outs == [z.compress(b) for b in bufs]


def test_encoder_matches_reference_shard_encoder():
    bufs = _bufs(k=3)
    ref = RefShardEncoder(zipnn=zipnn_tpu.ZipNN(engine="numpy", huffman_table="shared"))
    want = [bytes(o) for o in ref.compress_iter(bufs)]
    assert list(ShardEncoder(device="cpu").compress_iter(bufs)) == want


def test_encoder_other_engine_and_mixed_sizes_keep_order():
    """Containers with no full chunk between full ones, and a numpy-engine
    ``zipnn`` (its payloads computed at their start)."""
    bufs = [_bf16(700, seed=1), _bufs(k=1)[0], _bf16(900, seed=2), _bf16(CHUNK, seed=3)]
    for kw in ({"huffman_table": "shared"}, {}, {"engine": "numpy"}):
        z = _z(**kw)
        outs = list(ShardEncoder(zipnn=_z(**kw)).compress_iter(bufs))
        assert outs == [z.compress(b) for b in bufs], kw


def test_pool_staging_views_and_no_leak(out_pool):
    bufs = _bufs(k=4)
    z = _z()
    enc = ShardEncoder(zipnn=_z(), pool_staging=True)
    for _ in range(3):
        got = []
        for view in enc.compress_iter(bufs):
            assert isinstance(view, memoryview)
            got.append(bytes(view))  # consumed as it arrives
        assert got == [z.compress(b) for b in bufs]
        # two containers stay valid, the rest went back to the pool
        assert len(enc._held) == 2
        assert len(out_pool._out_pool) + len(enc._held) <= len(bufs) + 1
    assert all(not b.is_pinned() for b in out_pool._out_pool)  # no card: pageable


def test_compress_all_with_pool_staging_owns_its_bytes(out_pool):
    """More containers than the two-yield window: the earliest must not be
    overwritten by later ones reusing their pooled buffers."""
    bufs = _bufs(k=6, size=30_000)
    enc = ShardEncoder(zipnn=_z(), pool_staging=True)
    outs = enc.compress_all(bufs)
    assert all(isinstance(o, bytes) for o in outs)
    want = [_z().compress(b) for b in bufs]
    assert outs == want
    enc.compress_all(bufs[::-1])  # reuse every pooled buffer again
    assert outs == want


def test_early_exit_and_error_return_held_buffers(out_pool):
    bufs = _bufs(k=5, size=30_000)
    enc = ShardEncoder(zipnn=_z(), pool_staging=True)
    it = enc.compress_iter(bufs)
    for _ in range(3):
        next(it)
    assert len(enc._held) == 2
    it.close()  # the consumer stops early
    assert enc._held == []
    held = len(out_pool._out_pool)
    assert held >= 2
    bad = bufs[:2] + [object()]  # not bytes-like: the preparation raises
    enc = ShardEncoder(zipnn=_z(), pool_staging=True)
    got = []
    with pytest.raises(TypeError):
        for view in enc.compress_iter(bad):
            got.append(bytes(view))
    assert got == [_z().compress(b) for b in bufs[:1]]
    assert enc._held == [] and len(out_pool._out_pool) >= held


def test_short_staged_words_upload_inline():
    bufs = _bufs(k=3)
    want = [_z().compress(b) for b in bufs]
    staged = [torch.frombuffer(bytearray(bufs[0]), dtype=torch.uint8)]
    for words in ([], [None], staged, staged + [None] * 5):
        enc = ShardEncoder(zipnn=_z())
        assert list(enc.compress_iter(bufs, staged_words=words)) == want
    with pytest.raises(ValueError, match="staged words"):
        list(ShardEncoder(zipnn=_z()).compress_iter(bufs, staged_words=[staged[0][:-1]]))


def test_no_delta_knob_to_fall_back_on():
    """The reference's ``ShardEncoder`` claims a delta fallback that fails
    inside ``finish``.  The port's ``ZipNN`` takes no delta knob (ROADMAP
    M7a); when it does, ``ShardEncoder`` must refuse delta up front."""
    with pytest.raises(TypeError):
        ZipNN(delta_compressed_type="byte")
    assert not hasattr(_z(), "delta_compressed_type")
