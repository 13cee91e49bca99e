"""PyTorch port: shared-table Huffman decode (``ops/huf_shared.py``).

The table prep is held against the JAX package's ``expand_dtable8``; the
kernel's plain version is held bit-exactly against the JAX package's
lockstep decoder (``jax_entropy.decode_streams``: same stream words, start
bits and table) and, cell by cell, against the golden ``huf.decompress``,
tail lengths and unaligned output offsets included.  The CUDA kernel is
held against the plain version on the card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zipnn_tpu.ops import jax_entropy, pallas_huf
from zipnn_tpu.ops.entropy import huf
from zipnn_tpu_torch.ops import huf_shared

DTABLE = 4096


def _planes(sizes, seed):
    rng = np.random.default_rng(seed)
    return [np.clip(rng.normal(120, 5, n), 0, 255).astype(np.uint8) for n in sizes]


def _shared_cells(planes):
    """One shared table for all planes, and each plane's HUF block."""
    count = np.bincount(np.concatenate(planes), minlength=256)
    lengths, vals, header, tlog = huf.build_shared_table(count)
    assert tlog <= 8
    blobs = [huf.compress_with_table(p, lengths, vals, header) for p in planes]
    assert all(b is not None for b in blobs)
    return header, blobs


def _streams(blob):
    _, _, _, _, consumed = huf.read_stats(blob)
    rest = blob[consumed:]
    ls = [int.from_bytes(rest[i : i + 2], "little") for i in (0, 2, 4)]
    ls.append(len(rest) - 6 - sum(ls))
    offs = np.cumsum([6] + ls)
    return [rest[offs[k] : offs[k + 1]] for k in range(4)]


def _inputs(blobs, sizes, header, junk=0, row=None, base=0):
    """The wrapper's arguments: each cell's streams behind ``junk`` 0xFF
    bytes; cell i's output at ``base + i * row``."""
    row = row or max(sizes)
    parts, starts, lens, bits0, offs, olens = [], [], [], [], [], []
    pos = 0
    for i, (blob, n) in enumerate(zip(blobs, sizes)):
        parts.append(b"\xff" * junk)
        pos += junk
        o = base + i * row
        for s, seg in zip(_streams(blob), huf.segment_sizes(n)):
            parts.append(s)
            starts.append(pos)
            lens.append(len(s))
            bits0.append(jax_entropy.sentinel_bits(s))
            offs.append(o)
            olens.append(seg)
            pos += len(s)
            o += seg
    t = torch.from_numpy
    return (
        t(np.frombuffer(b"".join(parts), np.uint8).copy()), t(np.asarray(starts, np.int64)),
        t(np.asarray(lens, np.int32)), t(np.asarray(bits0, np.int32)),
        t(np.asarray(offs, np.int64)), t(np.asarray(olens, np.int32)),
        t(huf_shared.expand_table8(header)), base + len(blobs) * row,
    )


def test_expand_table8_matches_jax_expand_dtable8():
    header, _ = _shared_cells(_planes([3000, 3000], seed=1))
    w, r, tlog, _, _ = huf.read_stats(header)
    sym, nb = huf.build_dtable(w, r, tlog)
    packed = pallas_huf.expand_dtable8(sym, nb, tlog)[0].view(np.uint32)
    want = np.stack([packed & 0xFFFF, packed >> 16], axis=1).reshape(-1)
    np.testing.assert_array_equal(huf_shared.expand_table8(header).astype(np.uint32), want)


def test_plain_matches_jax_decode_streams():
    sizes = [4096] * 4  # decode_streams wants one static segment length
    header, blobs = _shared_cells(_planes(sizes, seed=2))
    w, r, tlog, _, _ = huf.read_stats(header)
    sym, nb = huf.build_dtable(w, r, tlog)
    dtable = np.zeros(DTABLE, np.int32)
    dtable[: sym.size] = sym.astype(np.int32) | (nb.astype(np.int32) << 8)
    streams = [s for b in blobs for s in _streams(b)]
    bits = np.asarray([jax_entropy.sentinel_bits(s) for s in streams], np.int32)
    S, seg = len(streams), 1024
    wpr = max(len(s) for s in streams) // 4 + 2
    words = jax_entropy.pack_streams_np(streams, wpr)
    syms, bl = jax_entropy.decode_streams(
        jnp.asarray(words.reshape(-1)), jnp.asarray(bits),
        jnp.full((S,), tlog, jnp.int32), jnp.zeros((S,), jnp.int32),
        jnp.asarray(dtable), seg, wpr,
    )
    t = torch.from_numpy
    out, bits_left = huf_shared.huf_shared_decode(
        t(words.reshape(-1).view(np.uint8).copy()),
        t(np.arange(S, dtype=np.int64) * wpr * 4),
        t(np.asarray([len(s) for s in streams], np.int32)), t(bits),
        t(np.arange(S, dtype=np.int64) * seg), t(np.full(S, seg, np.int32)),
        t(huf_shared.expand_table8(header)), S * seg,
    )
    np.testing.assert_array_equal(out.numpy().reshape(S, seg), np.asarray(syms))
    np.testing.assert_array_equal(bits_left.numpy(), np.asarray(bl))
    assert not np.any(bits_left.numpy())


def test_plain_matches_golden_with_tails_and_unaligned_offsets():
    sizes = [4096, 4097, 1001, 777, 4098, 257, 101]
    planes = _planes(sizes, seed=3)
    header, blobs = _shared_cells(planes)
    row = 4099  # odd row: streams start at every output alignment
    out, bits_left = huf_shared.huf_shared_decode(
        *_inputs(blobs, sizes, header, junk=37, row=row, base=3))
    assert not np.any(bits_left.numpy())
    for i, (p, blob, n) in enumerate(zip(planes, blobs, sizes)):
        got = out.numpy()[3 + i * row : 3 + i * row + n]
        np.testing.assert_array_equal(got, huf.decompress(blob, n))
        np.testing.assert_array_equal(got, p)


def test_corrupt_stream_ends_with_bits_left():
    sizes = [4096, 4096]
    header, blobs = _shared_cells(_planes(sizes, seed=4))
    streams = _streams(blobs[1])
    start = len(blobs[1]) - sum(len(s) for s in streams[1:])  # stream 1
    for bit in range(8 * (start + 3), 8 * (start + len(streams[1]) - 1)):
        bad = bytearray(blobs[1])
        bad[bit // 8] ^= 1 << (bit % 8)
        try:
            huf.decompress(bytes(bad), 4096)
        except ValueError:
            break
    else:
        pytest.fail("no rejected bit flip found")
    _, bits_left = huf_shared.huf_shared_decode(
        *_inputs([blobs[0], bytes(bad)], sizes, header))
    bl = bits_left.numpy()
    assert bl[4 + 1] != 0
    assert not np.any(np.delete(bl, 4 + 1))


def test_table_checks():
    rng = np.random.default_rng(5)
    wide = np.minimum(rng.geometric(0.05, 60000), 255).astype(np.uint8)
    blob = huf.compress(wide)  # a per-chunk table deeper than 8 bits
    _, _, tlog, _, consumed = huf.read_stats(blob)
    assert tlog > 8
    with pytest.raises(ValueError, match="table_log"):
        huf_shared.expand_table8(blob[:consumed])
    sizes = [1000]
    header, blobs = _shared_cells(_planes(sizes, seed=6))
    args = list(_inputs(blobs, sizes, header))
    args[6] = args[6][:128]
    with pytest.raises(ValueError, match="table shape"):
        huf_shared.huf_shared_decode(*args)
    args[6] = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(TypeError, match="table"):
        huf_shared.huf_shared_decode(*args)
