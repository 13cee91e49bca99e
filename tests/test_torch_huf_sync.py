"""PyTorch port: the warp schedule of the Huffman decode kernels K1 and K6
(``ops/huf_sync.py``).

``decode_segmented`` runs the kernels' phases (speculative count, merge-walk
synchronisation, prefix-sum write, the serial chain for a stream with an
``nb == 0`` step) on tensors.  It is held bit-exactly, symbols and
``bits_left``, against the lockstep plain versions (``huf_pc``,
``huf_shared``) and the JAX package's ``jax_entropy.decode_streams`` on
valid, short, empty, corrupt and adversarial streams, with a warp per
stream and, as launches of short streams run, a lane per stream.  The CUDA
kernels are held against the plain versions on the same streams in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zipnn_tpu.ops import jax_entropy
from zipnn_tpu.ops.entropy import huf
from zipnn_tpu_torch.ops import huf_pc, huf_shared, huf_sync

DTABLE = 4096
T = torch.from_numpy


@pytest.fixture(params=["warp", "lane"])
def schedule(request, monkeypatch):
    """Force the launch's schedule (``huf_pc.streams_per_warp``): a warp
    per stream, or a lane per stream."""
    for module in (huf_pc, huf_shared):
        monkeypatch.setattr(module, "GROUP_SYMBOLS",
                            0 if request.param == "warp" else 1 << 30)
    return request.param


def _split(blob: bytes):
    """(header, [4 streams]) of one HUF block."""
    _, _, _, _, consumed = huf.read_stats(blob)
    rest = blob[consumed:]
    ls = [int.from_bytes(rest[i : i + 2], "little") for i in (0, 2, 4)]
    ls.append(len(rest) - 6 - sum(ls))
    offs = np.cumsum([6] + ls)
    return blob[:consumed], [rest[offs[k] : offs[k + 1]] for k in range(4)]


def _args(streams, olens, junk=29, base=3):
    """Payload (each stream behind ``junk`` 0xFF bytes) and the stream
    arrays; outputs packed from ``base``, so at every alignment."""
    parts, starts, pos = [], [], 0
    for s in streams:
        parts += [b"\xff" * junk, s]
        starts.append(pos + junk)
        pos += junk + len(s)
    olens = np.asarray(olens, np.int32)
    offs = base + np.concatenate([[0], np.cumsum(olens)[:-1]]).astype(np.int64)
    args = (
        T(np.frombuffer(b"".join(parts), np.uint8).copy()), T(np.asarray(starts, np.int64)),
        T(np.asarray([len(s) for s in streams], np.int32)),
        T(np.asarray([jax_entropy.sentinel_bits(s) for s in streams], np.int32)),
        T(offs), T(olens),
    )
    return args, int(base + olens.sum())


def _per_cell(sizes, seed, spread=(3, 12)):
    """Per-cell blocks of ``sizes`` symbols: (planes, stream arrays, cells,
    tlogs, tables, n_out)."""
    rng = np.random.default_rng(seed)
    planes = [np.clip(rng.normal(100 + 7 * i, spread[i % 2], n), 0, 255).astype(np.uint8)
              for i, n in enumerate(sizes)]
    streams, olens, cells, headers = [], [], [], []
    for i, (p, n) in enumerate(zip(planes, sizes)):
        hdr, st = _split(huf.compress(p))
        headers.append(hdr)
        streams += st
        olens += huf.segment_sizes(n)
        cells += [i] * 4
    tables, tlogs, inv, _ = huf_pc.distinct_tables(headers)
    tables, tlogs = tables[inv], tlogs[inv]  # a row per cell
    args, n_out = _args(streams, olens)
    return planes, args, T(np.asarray(cells, np.int32)), T(tlogs), T(tables), n_out


def _shared(sizes, seed):
    rng = np.random.default_rng(seed)
    planes = [np.clip(rng.normal(120, 5, n), 0, 255).astype(np.uint8) for n in sizes]
    lengths, vals, header, _ = huf.build_shared_table(
        np.bincount(np.concatenate(planes), minlength=256))
    streams, olens = [], []
    for p, n in zip(planes, sizes):
        streams += _split(huf.compress_with_table(p, lengths, vals, header))[1]
        olens += huf.segment_sizes(n)
    args, n_out = _args(streams, olens)
    return planes, args, T(huf_shared.expand_table8(header)), n_out


def _check_pc(args, cells, tlogs, tables, n_out):
    """Model == lockstep plain version, bit for bit; the model's result."""
    want, want_bl = huf_pc.huf_pc_decode(*args, cells, tlogs, tables, n_out)
    got, got_bl, passes = huf_sync.decode_segmented(
        *args, n_out, cells=cells, tlogs=tlogs, tables=tables)
    assert torch.equal(got, want)
    assert torch.equal(got_bl, want_bl)
    return got, got_bl, passes


def _check_shared(args, table, n_out):
    want, want_bl = huf_shared.huf_shared_decode(*args, table, n_out)
    got, got_bl, passes = huf_sync.decode_segmented(*args, n_out, table=table)
    assert torch.equal(got, want)
    assert torch.equal(got_bl, want_bl)
    return got, got_bl, passes


def _jax(args, tlog_of_stream, cell_of_stream, rows, seg):
    """``jax_entropy.decode_streams`` over the same streams (each
    ``seg`` symbols) with int16 table ``rows``: (symbols [S, seg],
    bits_left)."""
    payload, starts, lens = (a.numpy() for a in args[:3])
    streams = [payload[s : s + n].tobytes() for s, n in zip(starts, lens)]
    wpr = int(lens.max()) // 4 + 2
    dt = np.zeros((rows.shape[0], DTABLE), np.int32)
    dt[:, : rows.shape[1]] = rows.numpy().astype(np.int32)
    syms, bl = jax_entropy.decode_streams(
        jnp.asarray(jax_entropy.pack_streams_np(streams, wpr).reshape(-1)),
        jnp.asarray(args[3].numpy()), jnp.asarray(np.asarray(tlog_of_stream, np.int32)),
        jnp.asarray(np.asarray(cell_of_stream, np.int32) * DTABLE),
        jnp.asarray(dt.reshape(-1)), seg, wpr)
    return np.asarray(syms), np.asarray(bl)


def _rows(out, args):
    """Each stream's symbols, [S, n] (one common n)."""
    offs, n = args[4].numpy(), int(args[5][0])
    return np.stack([out.numpy()[o : o + n] for o in offs])


def test_geometry():
    L, seg = huf_sync.lane_geometry(torch.tensor([-5, 0, 1, 255, 256, 5000, 88000]))
    assert L.tolist() == [1, 1, 1, 1, 1, 19, 32]
    assert seg.tolist() == [0, 0, 1, 255, 256, 264, 2750]


def test_streams_per_warp():
    """Launches whose streams average fewer than the kernel's
    GROUP_SYMBOLS symbols give each stream a lane of its own, and the
    model reports no passes; longer ones take a warp per stream."""
    assert huf_pc.streams_per_warp(1024 * 8, 8, 1024) == 1
    assert huf_pc.streams_per_warp(1024 * 8 - 1, 8, 1024) == 32
    # 1536 symbols a stream: a warp each on K1, a lane each on K6
    _, args, cells, tlogs, tables, n_out = _per_cell([6144, 6144], seed=8)
    _, bl, passes = _check_pc(args, cells, tlogs, tables, n_out)
    assert not bl.any() and passes.max() >= 1
    _, args, table, n_out = _shared([6144, 6144], seed=8)
    _, bl, passes = _check_shared(args, table, n_out)
    assert not bl.any() and not passes.any()


def test_per_cell_valid_streams_ragged_and_unaligned(schedule):
    sizes = [4096, 4097, 1001, 777, 4098, 257, 12000]
    planes, args, cells, tlogs, tables, n_out = _per_cell(sizes, seed=1)
    out, bl, passes = _check_pc(args, cells, tlogs, tables, n_out)
    assert not bl.any() and (passes >= 0).all()
    assert (passes.max() >= 1) if schedule == "warp" else not passes.any()
    offs = args[4].numpy()
    for i, (p, n) in enumerate(zip(planes, sizes)):
        np.testing.assert_array_equal(out.numpy()[offs[4 * i] : offs[4 * i] + n], p)


def test_shared_valid_streams_ragged_and_unaligned(schedule):
    sizes = [4096, 4097, 1001, 777, 4098, 257, 101, 20000]
    planes, args, table, n_out = _shared(sizes, seed=2)
    out, bl, passes = _check_shared(args, table, n_out)
    assert not bl.any() and (passes >= 0).all()
    offs = args[4].numpy()
    for i, (p, n) in enumerate(zip(planes, sizes)):
        np.testing.assert_array_equal(out.numpy()[offs[4 * i] : offs[4 * i] + n], p)


@pytest.mark.parametrize("profile", ["per_cell", "shared"])
def test_matches_jax_decode_streams(profile, schedule):
    sizes = [4096] * 4  # decode_streams wants one segment length
    if profile == "per_cell":
        _, args, cells, tlogs, tables, n_out = _per_cell(sizes, seed=3)
        out, bl, _ = _check_pc(args, cells, tlogs, tables, n_out)
        syms, jbl = _jax(args, tlogs.numpy()[cells.numpy()], cells.numpy(), tables, 1024)
    else:
        _, args, table, n_out = _shared(sizes, seed=3)
        out, bl, _ = _check_shared(args, table, n_out)
        syms, jbl = _jax(args, [8] * 16, [0] * 16, table.reshape(1, 256), 1024)
    np.testing.assert_array_equal(_rows(out, args), syms)
    np.testing.assert_array_equal(bl.numpy(), jbl)


def test_short_and_empty_streams(schedule):
    """32-symbol streams (128 B chunks) and streams shorter than one
    sub-segment take one lane; streams asked for 0 symbols keep bits0."""
    sizes = [128, 256, 64, 300, 128]
    _, args, cells, tlogs, tables, n_out = _per_cell(sizes, seed=4)
    _, bl, passes = _check_pc(args, cells, tlogs, tables, n_out)
    assert not bl.any() and not passes.any()
    assert (huf_sync.lane_geometry(args[3])[0] == 1).all()
    olens = args[5].clone()
    olens[::3] = 0
    args0 = (*args[:5], olens)
    _, bl0, _ = _check_pc(args0, cells, tlogs, tables, n_out)
    assert torch.equal(bl0[::3], args[3][::3])


@pytest.mark.parametrize("profile", ["per_cell", "shared"])
def test_flipped_bits_both_signs(profile, schedule):
    """Copies of one stream, each with one bit flipped: the decode runs
    past its sentinel (bits_left > 0) or past bit 0 (< 0), and the model
    still equals the serial chain."""
    if profile == "per_cell":
        _, base, cells, tlogs, tables, _ = _per_cell([4096], seed=5)
    else:
        _, base, table, _ = _shared([4096], seed=5)
    payload, starts, lens = (a.numpy() for a in base[:3])
    s = payload[starts[1] : starts[1] + lens[1]].tobytes()
    variants = []
    for bit in range(40, 8 * len(s) - 8, 8 * len(s) // 24):
        b = bytearray(s)
        b[bit // 8] ^= 1 << (bit % 8)
        variants.append(bytes(b))
    n = int(base[5][1])
    args, n_out = _args(variants, [n] * len(variants))
    S = len(variants)
    if profile == "per_cell":
        c = torch.zeros(S, dtype=torch.int32)
        out, bl, _ = _check_pc(args, c, tlogs, tables, n_out)
        syms, jbl = _jax(args, [int(tlogs[0])] * S, [0] * S, tables, n)
    else:
        out, bl, _ = _check_shared(args, table, n_out)
        syms, jbl = _jax(args, [8] * S, [0] * S, table.reshape(1, 256), n)
    np.testing.assert_array_equal(_rows(out, args), syms)
    np.testing.assert_array_equal(bl.numpy(), jbl)
    assert (bl > 0).any() and (bl < 0).any()


def _fixed_length_streams(n_syms, seed):
    """Streams of an 8-bit fixed-length code (symbol i = code i): decoders
    started at different bit phases never meet, so corrections cascade
    from lane to lane."""
    rng = np.random.default_rng(seed)
    ident = np.arange(256)
    streams = [huf.encode_stream(rng.integers(0, 256, n, dtype=np.uint8), ident,
                                 np.full(256, 8)) for n in n_syms]
    table = T((np.arange(256) | (8 << 8)).astype(np.int16))
    return streams, table


@pytest.mark.parametrize("profile", ["per_cell", "shared"])
def test_fixed_length_code_needs_many_sync_passes(profile, schedule):
    n_syms = [4001, 4001, 3001, 4001]
    streams, table = _fixed_length_streams(n_syms, seed=6)
    args, n_out = _args(streams, [4001] * 4)
    if profile == "per_cell":
        out, bl, passes = _check_pc(args, torch.zeros(4, dtype=torch.int32),
                                    torch.tensor([8], dtype=torch.int32),
                                    table.reshape(1, 256), n_out)
    else:
        out, bl, passes = _check_shared(args, table, n_out)
    syms, jbl = _jax(args, [8] * 4, [0] * 4, table.reshape(1, 256), 4001)
    np.testing.assert_array_equal(_rows(out, args), syms)
    np.testing.assert_array_equal(bl.numpy(), jbl)
    assert bl[2] < 0 and not bl[[0, 1, 3]].any()  # stream 2 is 1000 symbols short
    assert (int(passes.max()) >= 4) if schedule == "warp" else not passes.any()


def test_nb_zero_entry_takes_the_serial_chain(schedule):
    """A per-cell table whose most frequent symbol consumes 0 bits: the
    chain sticks there, the lanes of a warp hit their step cap, and the
    stream is decoded by the serial chain (which a lane per stream runs
    anyway)."""
    _, args, cells, tlogs, tables, n_out = _per_cell([4096, 4096], seed=7)
    bad = tables.clone()
    row = bad[1, : 1 << int(tlogs[1])]
    sym = int(torch.mode(row & 0xFF).values)
    row[(row & 0xFF) == sym] = sym
    out, bl, passes = _check_pc(args, cells, tlogs, bad, n_out)
    if schedule == "warp":
        assert (passes[4:] == -1).all() and (passes[:4] >= 0).all()
    else:
        assert not passes.any()
    assert not bl[:4].any()
    syms, jbl = _jax(args, tlogs.numpy()[cells.numpy()], cells.numpy(), bad, 1024)
    np.testing.assert_array_equal(_rows(out, args), syms)
    np.testing.assert_array_equal(bl.numpy(), jbl)
