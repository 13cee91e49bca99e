"""PyTorch port: the shared-table encode's two kernels, by their plain
versions, held against the JAX package with tolerance 0.

* K7 (``ops/huf_enc.py``): every stream's bytes and ``total_bits`` equal
  the golden ``huf.encode_stream`` on the same symbols, bit 30 marks a
  stream with an uncoded byte, and ``pack_etable`` packs what
  ``pallas_huf_enc.pack_etable8`` packs.
* K8 (``ops/const_scan.py``): the flags equal
  ``pallas_gather.const_scan_rows`` (its XLA path on the CPU).

The CUDA kernels are held against these plain versions on the card in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zipnn_tpu.ops import pallas_gather, pallas_huf_enc
from zipnn_tpu.ops.entropy import huf
from zipnn_tpu_torch.ops import const_scan, huf_enc

RNG = np.random.default_rng(7)


def _table(symbols):
    count = np.bincount(symbols, minlength=256)
    lengths, vals, _header, tlog = huf.build_shared_table(count)
    assert tlog <= 8
    return lengths, vals


def _streams_of(planes_u8: np.ndarray, seg: int):
    """Every seg-byte stream of the flat symbol bytes, as word offsets."""
    n = planes_u8.size // seg
    words = torch.from_numpy(planes_u8.view("<i4").copy())
    return words, torch.arange(n, dtype=torch.int64) * (seg // 4)


@pytest.mark.parametrize("seg,n_streams", [(0, 2), (4, 3), (64, 16), (1024, 9), (4096, 4)])
def test_plain_encode_matches_encode_stream(seg, n_streams):
    syms = np.clip(RNG.normal(120, 6, seg * n_streams), 0, 255).astype(np.uint8)
    if syms.size:
        syms[: seg // 2] = 120  # a run of the shortest code
    lengths, vals = _table(np.concatenate([syms, np.arange(100, 140, dtype=np.uint8)]))
    table = torch.from_numpy(huf_enc.pack_etable(vals, lengths))
    words, streams = _streams_of(syms, seg) if seg else (
        torch.zeros(1, dtype=torch.int32), torch.zeros(n_streams, dtype=torch.int64))
    rows, total = huf_enc.huf_shared_encode(words, table, seg, streams)
    assert rows.shape == (n_streams, seg // 4 + 1) and rows.dtype == torch.int32
    rb = rows.numpy().view(np.uint8)
    for s in range(n_streams):
        want = huf.encode_stream(syms[s * seg : (s + 1) * seg], vals, lengths)
        bits = int(total[s])
        assert bits >> 30 == 0
        assert (bits + 7) // 8 == len(want)
        assert bytes(rb[s, : len(want)]) == want


def test_plain_encode_flags_uncoded_byte_in_bit30():
    seg = 256
    syms = np.clip(RNG.normal(60, 3, 4 * seg), 0, 255).astype(np.uint8)
    lengths, vals = _table(syms)
    syms[seg + 17] = 250  # stream 1 only: a byte the table has no code for
    assert lengths[250] == 0
    words, streams = _streams_of(syms, seg)
    _, total = huf_enc.huf_shared_encode(
        words, torch.from_numpy(huf_enc.pack_etable(vals, lengths)), seg, streams)
    assert [int(t) >> 30 for t in total] == [0, 1, 0, 0]
    for s in (0, 2, 3):
        want = huf.encode_stream(syms[s * seg : (s + 1) * seg], vals, lengths)
        assert (int(total[s]) + 7) // 8 == len(want)


def test_plain_encode_reads_streams_at_word_offsets():
    """Streams picked out of a larger plane array, in any order."""
    seg = 128
    syms = np.clip(RNG.normal(90, 9, 10 * seg), 0, 255).astype(np.uint8)
    lengths, vals = _table(syms)
    words = torch.from_numpy(syms.view("<i4").copy())
    pick = [7, 2, 2, 9]
    streams = torch.tensor([p * seg // 4 for p in pick], dtype=torch.int64)
    rows, total = huf_enc.huf_shared_encode(
        words, torch.from_numpy(huf_enc.pack_etable(vals, lengths)), seg, streams)
    rb = rows.numpy().view(np.uint8)
    for i, p in enumerate(pick):
        want = huf.encode_stream(syms[p * seg : (p + 1) * seg], vals, lengths)
        assert bytes(rb[i, : len(want)]) == want and int(total[i]) >> 30 == 0


@pytest.mark.parametrize("codes", ["sampled", "all_8_bit", "all_1_bit"])
@pytest.mark.parametrize("seg", [60, 252, 508])
def test_plain_encode_at_word_offsets_of_every_residue(seg, codes):
    """Segments that are not a multiple of 16 bytes, read from word offsets
    of every residue mod 4, under a sampled table, codes of 8 bits and of
    1 bit."""
    rng = np.random.default_rng(seg)
    n, w = 8, seg // 4
    syms = np.clip(rng.normal(120, 7, 4 * (n * w + 4)), 0, 255).astype(np.uint8)
    if codes == "sampled":
        lengths, vals = _table(syms)
    else:
        nb = 8 if codes == "all_8_bit" else 1
        lengths = np.full(256, nb)
        vals = rng.permutation(256) if nb == 8 else np.arange(256) & 1
    offs = [s * w + (s * 3) % 4 for s in range(n)]
    rows, total = huf_enc.huf_shared_encode(
        torch.from_numpy(syms.view("<i4").copy()),
        torch.from_numpy(huf_enc.pack_etable(vals, lengths)), seg,
        torch.tensor(offs, dtype=torch.int64))
    rb = rows.numpy().view(np.uint8)
    for s, o in enumerate(offs):
        want = huf.encode_stream(syms[4 * o : 4 * o + seg], vals, lengths)
        assert int(total[s]) >> 30 == 0 and (int(total[s]) + 7) // 8 == len(want)
        assert bytes(rb[s, : len(want)]) == want


def test_schedule_follows_stream_length(monkeypatch):
    """K7's launch takes a warp per stream from ``WARP_SYMBOLS`` symbols on
    and a lane per stream below, from the length alone; the constant moves
    the crossover, so a test can force either schedule."""
    warp = huf_enc.WARP_SYMBOLS
    assert huf_enc.streams_per_warp(warp) == 1
    assert huf_enc.streams_per_warp(warp - 4) == 32
    assert huf_enc.streams_per_warp(32768) == 1 and huf_enc.streams_per_warp(0) == 32
    monkeypatch.setattr(huf_enc, "WARP_SYMBOLS", 0)
    assert huf_enc.streams_per_warp(0) == 1
    monkeypatch.setattr(huf_enc, "WARP_SYMBOLS", 1 << 30)
    assert huf_enc.streams_per_warp(32768) == 32


@pytest.mark.parametrize("n_streams,seg,forced,parts", [
    (16, 32768, None, 16),   # a 1 MiB bf16 frame's exponent planes
    (64, 32768, None, 16),
    (256, 32768, None, 4),
    (512, 32768, None, 2),
    (1024, 32768, None, 1),
    (2048, 32768, None, 1),
    (8192, 32768, None, 1),  # the main path's batch: 2 048 chunks of 256 KB
    (16, 2048, None, 2),     # 2 tiles: a part keeps at least one
    (16, 512, None, 1),
    (8192, 32768, 8, 8),     # PARTS forces the split
])
def test_split_follows_stream_count(n_streams, seg, forced, parts, monkeypatch):
    """``huf_pc_encode``'s warps a stream, picked from the launch's stream
    count and length alone: doubled while the launch holds fewer than
    ``PART_WARPS`` warps and each part keeps a tile; ``PARTS`` forces it."""
    monkeypatch.setattr(huf_enc, "PARTS", forced)
    assert huf_enc.parts_per_stream(n_streams, seg) == parts


def test_forced_split_must_be_a_power_of_2(monkeypatch):
    words = torch.zeros(64, dtype=torch.int32)
    tables = torch.zeros((1, 256), dtype=torch.int16)
    streams = torch.zeros(4, dtype=torch.int64)
    for bad in (3, 2 * huf_enc.MAX_PARTS, 0):
        monkeypatch.setattr(huf_enc, "PARTS", bad)
        with pytest.raises(ValueError):
            huf_enc.huf_pc_encode(words, tables, 64, streams)


def test_pack_etable_matches_pack_etable8():
    lengths, vals = _table(np.clip(RNG.normal(128, 20, 50000), 0, 255).astype(np.uint8))
    got = huf_enc.pack_etable(vals, lengths).astype(np.int64) & 0xFFFF
    packed = pallas_huf_enc.pack_etable8(vals, lengths)[0].view(np.uint32)
    want = np.stack([packed & 0xFFFF, packed >> 16], axis=1).reshape(-1)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="8-bit"):
        huf_enc.pack_etable(vals, np.where(lengths > 0, 9, 0))


def test_encode_wrapper_checks_arguments():
    w = torch.zeros(64, dtype=torch.int32)
    t = torch.zeros(256, dtype=torch.int16)
    s = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(TypeError):
        huf_enc.huf_shared_encode(w.to(torch.int64), t, 64, s)
    with pytest.raises(ValueError, match="multiple of 4"):
        huf_enc.huf_shared_encode(w, t, 62, s)
    with pytest.raises(ValueError, match="table shape"):
        huf_enc.huf_shared_encode(w, t[:128], 64, s)


def _scan_rows():
    rows = RNG.integers(0, 1 << 32, (12, 40), dtype=np.uint64).astype(np.uint32)
    for i, b in enumerate((0x00, 0xFF, 0x7F, 0x80)):
        rows[i] = b * 0x01010101  # constant rows, b0 = 0 and 0xFF among them
    rows[4] = 0x3C3C3C3C
    rows[4, -1] = 0x3D3C3C3C  # differs only in its last byte
    rows[5] = 0
    rows[5, 0] = 0x100  # differs only in its second byte
    return rows


def test_plain_const_scan_matches_jax():
    rows = _scan_rows()
    got = const_scan.const_scan_rows(torch.from_numpy(rows.view(np.int32)))
    want = np.asarray(pallas_gather.const_scan_rows(jnp.asarray(rows)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(got.numpy()[:6]) == [0x100, 0x1FF, 0x17F, 0x180, 0x3C, 0]


def test_const_scan_wrapper_checks_arguments():
    with pytest.raises(TypeError):
        const_scan.const_scan_rows(torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        const_scan.const_scan_rows(torch.zeros((2, 0), dtype=torch.int32))
    with pytest.raises(ValueError):
        const_scan.const_scan_rows(torch.zeros((4, 4), dtype=torch.int32)[:, ::2])
