"""PyTorch port: per-cell-table Huffman decode (``ops/huf_pc.py``).

The kernel's plain version is held bit-exactly against the JAX package's
lockstep decoder (``jax_entropy.decode_streams``: same stream words, start
bits and decode tables) and, cell by cell, against the golden
``huf.decompress``, tail lengths included.  The CUDA kernel is held
against the plain version on the card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zipnn_tpu.ops import jax_entropy
from zipnn_tpu.ops.entropy import huf
from zipnn_tpu_torch.ops import huf_pc

RNG = np.random.default_rng(99)
DTABLE = 4096


def _plane(n: int, kind: int) -> np.ndarray:
    if kind == 0:
        return np.clip(RNG.normal(120, 6, n), 0, 255).astype(np.uint8)
    if kind == 1:
        return RNG.integers(0, 7, n).astype(np.uint8)
    return np.clip(RNG.normal(60, 25, n), 0, 255).astype(np.uint8)


def _split_cell(blob: bytes):
    """(header bytes, [4 streams]) of one HUF block."""
    weights, rank_stats, tlog, _, consumed = huf.read_stats(blob)
    rest = blob[consumed:]
    l1, l2, l3 = (int.from_bytes(rest[i : i + 2], "little") for i in (0, 2, 4))
    l4 = len(rest) - 6 - l1 - l2 - l3
    streams, off = [], 6
    for ln in (l1, l2, l3, l4):
        streams.append(rest[off : off + ln])
        off += ln
    return blob[:consumed], streams


def _cells(sizes, kinds):
    planes = [_plane(n, k) for n, k in zip(sizes, kinds)]
    blobs = [huf.compress(p) for p in planes]
    assert all(b is not None and len(b) > 1 for b in blobs)
    return planes, blobs


def _inputs(blobs, sizes, junk: int = 0, row: int = None):
    """Payload (each cell behind ``junk`` 0xFF bytes, so a stream's
    neighbours are real nonzero data) and the wrapper's stream arrays."""
    row = row or max(sizes)
    parts, starts, lens, bits0, offs, olens, cells = [], [], [], [], [], [], []
    pos = 0
    headers = []
    for i, (blob, n) in enumerate(zip(blobs, sizes)):
        hdr, streams = _split_cell(blob)
        headers.append(hdr)
        parts.append(b"\xff" * junk)
        pos += junk
        seg = huf.segment_sizes(n)
        o = i * row
        for k, s in enumerate(streams):
            parts.append(s)
            starts.append(pos)
            lens.append(len(s))
            bits0.append(jax_entropy.sentinel_bits(s))
            offs.append(o)
            olens.append(seg[k])
            cells.append(i)
            pos += len(s)
            o += seg[k]
    tables, tlogs, _ = huf_pc.cell_tables(headers)
    payload = np.frombuffer(b"".join(parts), np.uint8).copy()
    t = torch.from_numpy
    args = (
        t(payload), t(np.asarray(starts, np.int64)), t(np.asarray(lens, np.int32)),
        t(np.asarray(bits0, np.int32)), t(np.asarray(offs, np.int64)),
        t(np.asarray(olens, np.int32)), t(np.asarray(cells, np.int32)),
        t(tlogs), t(tables), len(blobs) * row,
    )
    return args


def test_cell_tables_match_build_dtable():
    _, blobs = _cells([4096, 3000, 5000], [0, 1, 2])
    headers = [_split_cell(b)[0] for b in blobs]
    tables, tlogs, tlog_k = huf_pc.cell_tables(headers + headers[:1])
    assert tlog_k == int(tlogs.max()) and tables.shape == (4, 1 << tlog_k)
    for i, h in enumerate(headers):
        w, r, tlog, _, _ = huf.read_stats(h)
        sym, nb = huf.build_dtable(w, r, tlog)
        assert tlogs[i] == tlog
        np.testing.assert_array_equal(tables[i, : 1 << tlog], sym.astype(np.int16) | (nb.astype(np.int16) << 8))
    np.testing.assert_array_equal(tables[3], tables[0])


def test_plain_matches_jax_decode_streams():
    sizes = [4096] * 5  # decode_streams wants one static segment length
    _, blobs = _cells(sizes, [0, 1, 2, 0, 1])
    seg = 1024
    stream_blobs, bits, tlogs, dtables = [], [], [], []
    for blob in blobs:
        hdr, streams = _split_cell(blob)
        w, r, tlog, _, _ = huf.read_stats(hdr)
        sym, nb = huf.build_dtable(w, r, tlog)
        ent = np.zeros(DTABLE, np.int32)
        ent[: sym.size] = sym.astype(np.int32) | (nb.astype(np.int32) << 8)
        dtables.append(ent)
        for s in streams:
            stream_blobs.append(s)
            bits.append(jax_entropy.sentinel_bits(s))
            tlogs.append(tlog)
    wpr = max(len(s) for s in stream_blobs) // 4 + 2
    words = jax_entropy.pack_streams_np(stream_blobs, wpr)
    S = len(stream_blobs)
    syms, bl = jax_entropy.decode_streams(
        jnp.asarray(words.reshape(-1)), jnp.asarray(np.asarray(bits, np.int32)),
        jnp.asarray(np.asarray(tlogs, np.int32)),
        jnp.asarray(np.repeat(np.arange(len(blobs), dtype=np.int32) * DTABLE, 4)),
        jnp.asarray(np.concatenate(dtables)), seg, wpr,
    )
    # the same words, start bits and tables through the port's plain version
    t = torch.from_numpy
    out, bits_left = huf_pc.huf_pc_decode(
        t(words.reshape(-1).view(np.uint8).copy()),
        t(np.arange(S, dtype=np.int64) * wpr * 4),
        t(np.asarray([len(s) for s in stream_blobs], np.int32)),
        t(np.asarray(bits, np.int32)), t(np.arange(S, dtype=np.int64) * seg),
        t(np.full(S, seg, np.int32)), t(np.repeat(np.arange(len(blobs), dtype=np.int32), 4)),
        t(np.asarray(tlogs[::4], np.int32)),
        t(np.stack(dtables).astype(np.int16)), S * seg,
    )
    np.testing.assert_array_equal(out.numpy().reshape(S, seg), np.asarray(syms))
    np.testing.assert_array_equal(bits_left.numpy(), np.asarray(bl))
    assert not np.any(bits_left.numpy())


def test_plain_matches_golden_per_cell_with_tail_lengths():
    sizes = [4096, 4097, 1001, 777, 4098, 257]
    planes, blobs = _cells(sizes, [0, 1, 2, 0, 2, 1])
    args = _inputs(blobs, sizes, junk=37)
    out, bits_left = huf_pc.huf_pc_decode(*args)
    assert not np.any(bits_left.numpy())
    row = max(sizes)
    for i, (p, blob, n) in enumerate(zip(planes, blobs, sizes)):
        got = out.numpy()[i * row : i * row + n]
        np.testing.assert_array_equal(got, huf.decompress(blob, n))
        np.testing.assert_array_equal(got, p)


def test_corrupt_stream_ends_with_bits_left():
    sizes = [4096, 4096]
    _, blobs = _cells(sizes, [0, 2])
    hdr, streams = _split_cell(blobs[1])
    start = len(blobs[1]) - sum(len(s) for s in streams[2:])  # stream 2
    for bit in range(8 * (start + 3), 8 * (start + len(streams[2]) - 1)):
        bad = bytearray(blobs[1])
        bad[bit // 8] ^= 1 << (bit % 8)
        try:
            huf.decompress(bytes(bad), 4096)
        except ValueError:
            break
    else:
        pytest.fail("no rejected bit flip found")
    _, bits_left = huf_pc.huf_pc_decode(*_inputs([blobs[0], bytes(bad)], sizes))
    bl = bits_left.numpy()
    assert bl[4 + 2] != 0
    assert not np.any(np.delete(bl, 4 + 2))


def test_wrapper_checks_types():
    sizes = [4096]
    _, blobs = _cells(sizes, [0])
    args = list(_inputs(blobs, sizes))
    args[1] = args[1].to(torch.int32)
    with pytest.raises(TypeError, match="starts"):
        huf_pc.huf_pc_decode(*args)

