"""PyTorch port on the card: each CUDA kernel against its plain version,
the whole decode and both profiles' encode against the golden model, the
staging pool both ways, and the serving load and checkpoint save.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
This file imports neither ``jax`` nor ``zipnn_tpu``, so it runs where only
PyTorch is installed:

    ZIPNN_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_cuda.py -q

(``ZIPNN_TPU_TESTS=1`` keeps ``tests/conftest.py`` from importing JAX.)
"""
import json

import numpy as np
import pytest
import torch

from zipnn_tpu_torch import CorruptChunkError, ZipNN, codec, native, stats
from zipnn_tpu_torch.ops import (
    combine, const_scan, decode, encode, hist, huf_enc, huf_pc, huf_shared, huf_sync, kernels,
    splice, staging, transforms,
)
from zipnn_tpu_torch.ops.byte_group import plane_lengths
from zipnn_tpu_torch.ops.entropy import huf

pytestmark = pytest.mark.cuda
CHUNK = 16384


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(args, dev):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)


def _k1_inputs(sizes, seed):
    """Cells of several tables and lengths behind 0xFF junk bytes."""
    rng = np.random.default_rng(seed)
    row = max(sizes)
    parts, starts, lens, bits0, offs, olens, cells, headers = [], [], [], [], [], [], [], []
    pos = 0
    for i, n in enumerate(sizes):
        plane = np.clip(rng.normal(100 + 10 * i, 3 + 2 * i, n), 0, 255).astype(np.uint8)
        blob = huf.compress(plane)
        _, _, _, _, consumed = huf.read_stats(blob)
        headers.append(blob[:consumed])
        rest = blob[consumed:]
        ls = [int.from_bytes(rest[j : j + 2], "little") for j in (0, 2, 4)]
        ls.append(len(rest) - 6 - sum(ls))
        parts.append(b"\xff" * 29 + rest[6:])
        pos += 29
        o = i * row
        for k, (ln, seg) in enumerate(zip(ls, huf.segment_sizes(n))):
            s = rest[6 + sum(ls[:k]) : 6 + sum(ls[: k + 1])]
            starts.append(pos)
            lens.append(ln)
            bits0.append(8 * (ln - 1) + s[-1].bit_length() - 1)
            offs.append(o)
            olens.append(seg)
            cells.append(i)
            pos += ln
            o += seg
    tables, tlogs, inv, _ = huf_pc.distinct_tables(headers)
    tables, tlogs = tables[inv], tlogs[inv]  # a row per cell
    t = torch.from_numpy
    return (
        t(np.frombuffer(b"".join(parts), np.uint8).copy()), t(np.asarray(starts, np.int64)),
        t(np.asarray(lens, np.int32)), t(np.asarray(bits0, np.int32)),
        t(np.asarray(offs, np.int64)), t(np.asarray(olens, np.int32)),
        t(np.asarray(cells, np.int32)), t(tlogs), t(tables), len(sizes) * row,
    )


def test_huf_pc_kernel_matches_plain(card):
    sizes = [4096, 4097, 1001, 777, 4098, 257, 131072]
    args = _k1_inputs(sizes, seed=1)
    want, want_bl = huf_pc.huf_pc_decode(*args)
    got, got_bl = huf_pc.huf_pc_decode(*_to(args, card))
    torch.cuda.synchronize()
    row = max(sizes)
    for i, n in enumerate(sizes):
        assert torch.equal(got[i * row : i * row + n].cpu(), want[i * row : i * row + n]), i
    assert torch.equal(got_bl.cpu(), want_bl)
    assert not want_bl.any()


def _k6_inputs(sizes, seed, row, base):
    """Cells of one shared table behind 0xFF junk bytes; cell i's output
    at ``base + i * row`` (any alignment)."""
    rng = np.random.default_rng(seed)
    planes = [np.clip(rng.normal(100, 4, n), 0, 255).astype(np.uint8) for n in sizes]
    lengths, vals, header, _ = huf.build_shared_table(
        np.bincount(np.concatenate(planes), minlength=256))
    parts, starts, lens, bits0, offs, olens = [], [], [], [], [], []
    pos = 0
    for i, (plane, n) in enumerate(zip(planes, sizes)):
        blob = huf.compress_with_table(plane, lengths, vals, header)
        rest = blob[len(header):]
        ls = [int.from_bytes(rest[j : j + 2], "little") for j in (0, 2, 4)]
        ls.append(len(rest) - 6 - sum(ls))
        parts.append(b"\xff" * 29 + rest[6:])
        pos += 29
        o = base + i * row
        for k, (ln, seg) in enumerate(zip(ls, huf.segment_sizes(n))):
            s = rest[6 + sum(ls[:k]) : 6 + sum(ls[: k + 1])]
            starts.append(pos)
            lens.append(ln)
            bits0.append(8 * (ln - 1) + s[-1].bit_length() - 1)
            offs.append(o)
            olens.append(seg)
            pos += ln
            o += seg
    t = torch.from_numpy
    return (
        t(np.frombuffer(b"".join(parts), np.uint8).copy()), t(np.asarray(starts, np.int64)),
        t(np.asarray(lens, np.int32)), t(np.asarray(bits0, np.int32)),
        t(np.asarray(offs, np.int64)), t(np.asarray(olens, np.int32)),
        t(huf_shared.expand_table8(header)), base + len(sizes) * row,
    ), planes


def test_huf_shared_kernel_matches_plain(card):
    sizes = [4096, 4097, 1001, 777, 4098, 257, 101, 131072]
    row, base = 131075, 3  # streams start at every output alignment
    args, planes = _k6_inputs(sizes, seed=1, row=row, base=base)
    want, want_bl = huf_shared.huf_shared_decode(*args)
    got, got_bl = huf_shared.huf_shared_decode(*_to(args, card))
    torch.cuda.synchronize()
    for i, n in enumerate(sizes):
        sl = slice(base + i * row, base + i * row + n)
        assert torch.equal(got[sl].cpu(), want[sl]), i
        assert torch.equal(want[sl], torch.from_numpy(planes[i])), i
    assert torch.equal(got_bl.cpu(), want_bl)
    assert not want_bl.any()


def _split_streams(blob):
    """(header, [4 streams]) of one HUF block."""
    _, _, _, _, consumed = huf.read_stats(blob)
    rest = blob[consumed:]
    ls = [int.from_bytes(rest[j : j + 2], "little") for j in (0, 2, 4)]
    ls.append(len(rest) - 6 - sum(ls))
    offs = np.cumsum([6] + ls)
    return blob[:consumed], [rest[offs[k] : offs[k + 1]] for k in range(4)]


def _stream_args(streams, olens, base=3):
    """Stream arrays of ``streams`` (each behind 29 0xFF bytes), outputs
    packed from ``base``; (arrays, n_out)."""
    parts, starts, pos = [], [], 0
    for st in streams:
        parts += [b"\xff" * 29, st]
        starts.append(pos + 29)
        pos += 29 + len(st)
    olens = np.asarray(olens, np.int32)
    offs = base + np.concatenate([[0], np.cumsum(olens)[:-1]]).astype(np.int64)
    t = torch.from_numpy
    return (
        t(np.frombuffer(b"".join(parts), np.uint8).copy()), t(np.asarray(starts, np.int64)),
        t(np.asarray([len(st) for st in streams], np.int32)),
        t(np.asarray([8 * (len(st) - 1) + st[-1].bit_length() - 1 for st in streams], np.int32)),
        t(offs), t(olens),
    ), int(base + olens.sum())


def _hard_case(case, shared):
    """Streams that a warp-per-stream decoder must get right (the cases of
    ``test_torch_huf_sync.py``): the wrapper's arguments (K6's for
    ``shared``, else K1's)."""
    rng = np.random.default_rng(11)
    ident = np.arange(256)
    if case == "fixed_length":  # an 8-bit code: every lane's correction cascades
        streams = [huf.encode_stream(rng.integers(0, 256, n, dtype=np.uint8), ident,
                                     np.full(256, 8)) for n in (4001, 4001, 3001, 4001)]
        args, n_out = _stream_args(streams, [4001] * 4)
        table = torch.from_numpy((ident | (8 << 8)).astype(np.int16))
        if shared:
            return (*args, table, n_out)
        return (*args, torch.zeros(4, dtype=torch.int32),
                torch.tensor([8], dtype=torch.int32), table.reshape(1, 256), n_out)
    sizes = [4096] if case == "flipped" else (
        [128, 256, 96, 300, 128] if case == "short_empty" else [4096, 4096, 12000])
    planes = [np.clip(rng.normal(120 if shared else 100 + 7 * i,
                                 5 if shared else (3, 12)[i % 2], n), 0, 255).astype(np.uint8)
              for i, n in enumerate(sizes)]
    if shared:
        lengths, vals, header, _ = huf.build_shared_table(
            np.bincount(np.concatenate(planes), minlength=256))
        blobs = [huf.compress_with_table(p, lengths, vals, header) for p in planes]
        headers = [header]
    else:
        blobs = [huf.compress(p) for p in planes]
        headers = [_split_streams(b)[0] for b in blobs]
    streams = [st for b in blobs for st in _split_streams(b)[1]]
    olens = [k for n in sizes for k in huf.segment_sizes(n)]
    cells = np.repeat(np.arange(len(sizes), dtype=np.int32), 4)
    if case == "flipped":  # one stream, one bit flipped per copy: bits_left of both signs
        st = streams[1]
        streams = []
        for bit in range(40, 8 * len(st) - 8, 8 * len(st) // 24):
            b = bytearray(st)
            b[bit // 8] ^= 1 << (bit % 8)
            streams.append(bytes(b))
        olens = [olens[1]] * len(streams)
        cells = np.zeros(len(streams), np.int32)
    elif case == "short_empty":  # one lane each; some asked for 0 symbols
        olens = [0 if i % 3 == 0 else n for i, n in enumerate(olens)]
    args, n_out = _stream_args(streams, olens)
    if shared:
        return (*args, torch.from_numpy(huf_shared.expand_table8(header)), n_out)
    tables, tlogs, inv, _ = huf_pc.distinct_tables(headers)
    tables, tlogs = tables[inv], tlogs[inv]  # a row per cell
    if case == "nb_zero":  # cell 1's most frequent symbol consumes 0 bits
        row = tables[1, : 1 << int(tlogs[1])]
        sym = np.bincount(row & 0xFF).argmax()
        row[(row & 0xFF) == sym] = sym
    return (*args, torch.from_numpy(cells), torch.from_numpy(tlogs),
            torch.from_numpy(tables), n_out)


@pytest.mark.parametrize("schedule", ["warp", "lane"])
@pytest.mark.parametrize("case,shared", [
    ("flipped", False), ("flipped", True), ("fixed_length", False), ("fixed_length", True),
    ("short_empty", False), ("short_empty", True), ("nb_zero", False),
])
def test_huf_decode_kernels_on_hard_streams(card, case, shared, schedule, monkeypatch):
    """K1 / K6 against their plain versions on corrupt, adversarial, short
    and empty streams, with a warp per stream and with a lane per stream
    (``GROUP_SYMBOLS`` forces the launch's schedule): symbols and
    bits_left bit-exact, and the kernel's sync passes per stream equal to
    the model's (``huf_sync``)."""
    for m in (huf_pc, huf_shared):
        monkeypatch.setattr(m, "GROUP_SYMBOLS", 0 if schedule == "warp" else 1 << 30)
    args = _hard_case(case, shared)
    module = huf_shared if shared else huf_pc
    wrapper = huf_shared.huf_shared_decode if shared else huf_pc.huf_pc_decode
    want, want_bl = wrapper(*args)
    got, got_bl = wrapper(*_to(args, card))
    torch.cuda.synchronize()
    for o, n in zip(args[4].tolist(), args[5].tolist()):
        assert torch.equal(got[o : o + n].cpu(), want[o : o + n]), (o, n)
    assert torch.equal(got_bl.cpu(), want_bl)
    tabs = {"table": args[6]} if shared else dict(zip(("cells", "tlogs", "tables"), args[6:9]))
    _, _, passes = huf_sync.decode_segmented(*args[:6], args[-1], **tabs)
    assert torch.equal(module.last_sync_passes.cpu(), passes)
    if case == "flipped":
        assert (want_bl > 0).any() and (want_bl < 0).any()
    if schedule == "lane":
        assert not passes.any()
    elif case == "fixed_length":
        assert int(passes.max()) >= 4
    elif case == "nb_zero":
        assert (passes[4:8] == -1).all() and (passes[:4] >= 0).all()


def _k2_inputs(total, num_buf, byte_reorder, bit_reorder, seed, cs=1024):
    """Cells of every kind (cell i's kind is (i + seed) % 3, so a 4-plane
    chunk holds all three), each stored cell one residue mod 16 further
    into the payload than the one before, symbol rows of cs / num_buf
    bytes (any alignment)."""
    rng = np.random.default_rng(seed)
    n_chunks = -(-total // cs)
    row = cs // num_buf
    payload = bytearray(rng.integers(0, 256, 5, dtype=np.uint8).tobytes())
    hsym = rng.integers(0, 256, (n_chunks * num_buf, row), dtype=np.uint8)
    kinds, srcs = [], []
    n_stored = 0
    for c in range(n_chunks):
        lens = plane_lengths(min(cs, total - c * cs), num_buf, byte_reorder)
        for b in range(num_buf):
            kind = (c * num_buf + b + seed) % 3
            if kind == 0:
                pad = (n_stored - len(payload)) % 16
                payload += rng.integers(0, 256, pad, dtype=np.uint8).tobytes()
                n_stored += 1
                src = len(payload)
                payload += rng.integers(0, 256, lens[b], dtype=np.uint8).tobytes()
            elif kind == 1:
                src = int(rng.integers(0, 256))
            else:
                src = c * num_buf + b
            kinds.append(kind)
            srcs.append(src)
    t = torch.from_numpy
    return (
        t(np.frombuffer(bytes(payload), np.uint8).copy()), t(hsym.reshape(-1)),
        t(np.asarray(kinds, np.int32)), t(np.asarray(srcs, np.int64)), row, cs,
        total, num_buf, byte_reorder, bit_reorder,
    )


@pytest.mark.parametrize("cs", [4, 12, 20, 260, 1024, 4100, 262144])
@pytest.mark.parametrize("bit_reorder", [0, 1])
@pytest.mark.parametrize("num_buf,byte_reorder", [(1, 10), (2, 10), (2, 1), (2, 8), (4, 220)])
def test_combine_kernel_matches_plain(card, num_buf, byte_reorder, bit_reorder, cs):
    """K2 against its plain version: every plane layout, with and without
    the sign rotation, at chunk sizes whose planes, symbol rows and chunk
    starts take every alignment (the vector path and the per-word path);
    tails of every residue mod 16; into an ``out`` that is 16-byte aligned
    and one that is only 4-byte aligned, with nothing written past the
    word padding."""
    n_full = max(2, min(48 // num_buf, (4 << 20) // cs))
    for tail in sorted(set(range(min(cs, 16))) | {cs - 1}):
        total = n_full * cs + tail
        args = _k2_inputs(total, num_buf, byte_reorder, bit_reorder, seed=tail, cs=cs)
        n = -(-total // 4) * 4
        want = torch.full((n,), 0xAA, dtype=torch.uint8)
        combine.combine_cells(*args, want)
        dev_args = _to(args, card)
        for off in (0, 4):
            buf = torch.full((n + 16,), 0xAA, dtype=torch.uint8, device=card)
            combine.combine_cells(*dev_args, buf[off : off + n])
            torch.cuda.synchronize()
            got = buf.cpu()
            assert torch.equal(got[off : off + n], want), (tail, off)
            assert (got[off + n :] == 0xAA).all() and (got[:off] == 0xAA).all(), (tail, off)


def _raw(dtype, nbytes, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.float8_e4m3fn:
        return np.clip(rng.normal(56, 6, nbytes), 0, 255).astype(np.uint8)
    vals = (rng.standard_normal(nbytes // 2) * 0.05).astype(np.float32)
    if dtype == torch.float32:
        return vals[: nbytes // 4].view(np.uint8)
    if dtype == torch.bfloat16:
        return (vals.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8)
    return vals.astype(np.float16).view(np.uint8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float8_e4m3fn])
def test_decode_on_card_matches_golden(card, dtype):
    raw = _raw(dtype, 9 * CHUNK + 6002, seed=3)
    x = torch.from_numpy(raw.copy()).view(dtype)
    comp = ZipNN(input_format="torch", engine="numpy", compression_chunk=CHUNK).compress(x)
    kernels.reset_launches()
    y = ZipNN(input_format="torch", engine="cuda").decompress(comp)
    torch.cuda.synchronize()
    assert y.is_cuda and y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8))
    assert kernels.launches["huf_pc_decode"] > 0 and kernels.launches["combine_cells"] > 0
    ms = decode.kernel_ms()
    assert ms["huf_pc_decode"] > 0 and ms["combine_cells"] > 0


@pytest.mark.parametrize("profile", ["per_chunk", "shared"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                                   torch.float32])
def test_both_profiles_decode_on_card(card, dtype, profile):
    raw = _raw(dtype, 9 * CHUNK + 6004, seed=5)
    x = torch.from_numpy(raw.copy()).view(dtype)
    comp = ZipNN(input_format="torch", engine="numpy", compression_chunk=CHUNK,
                 huffman_table=profile).compress(x)
    kernels.reset_launches()
    y = ZipNN(input_format="torch", engine="cuda").decompress(comp)
    torch.cuda.synchronize()
    assert y.is_cuda and y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8))
    decoder = "huf_shared_decode" if profile == "shared" else "huf_pc_decode"
    assert decode.last_timings["decoder"] == decoder
    assert kernels.launches[decoder] > 0 and kernels.launches["combine_cells"] > 0
    if profile == "shared":
        assert kernels.launches["huf_pc_decode"] == 0
    assert decode.kernel_ms()[decoder] > 0


@pytest.mark.parametrize("raw", [
    b"", b"\x01\x02\x03", bytes(3 * CHUNK + 10),
    np.random.default_rng(2).integers(0, 256, 3 * CHUNK + 11, dtype=np.uint8).tobytes(),
], ids=["empty", "tiny", "all-rle", "all-stored"])
def test_decode_edge_containers_on_card(card, raw):
    comp = ZipNN(engine="numpy", compression_chunk=CHUNK).compress(raw)
    assert bytes(ZipNN(engine="cuda").decompress(comp)) == raw


def test_corrupt_stream_raises_on_card(card):
    raw = _raw(torch.bfloat16, 4 * CHUNK, seed=4)
    comp = bytes(ZipNN(engine="numpy", compression_chunk=CHUNK).compress(raw.tobytes()))
    z = ZipNN(engine="numpy")
    after = z._retrieve_header(memoryview(comp))
    plan = decode.build_plan(memoryview(comp)[after:], 2, 1, 10, CHUNK, raw.size)
    s0, ln = after + int(plan.starts[5]), int(plan.lens[5])
    for bit in range(8 * (ln // 2), 8 * (ln - 1)):
        bad = bytearray(comp)
        bad[s0 + bit // 8] ^= 1 << (bit % 8)
        try:
            ZipNN(engine="cuda", device="cpu").decompress(bytes(bad))
        except CorruptChunkError as exc:
            want = (exc.plane, exc.chunk, exc.stream)
            break
    else:
        pytest.fail("no rejected bit flip found")
    with pytest.raises(CorruptChunkError) as got:
        ZipNN(engine="cuda").decompress(bytes(bad))
    assert (got.value.plane, got.value.chunk, got.value.stream) == want
    assert want[2] == 1


def test_corrupt_shared_stream_raises_on_card(card):
    raw = _raw(torch.bfloat16, 4 * CHUNK, seed=6)
    comp = bytes(ZipNN(engine="numpy", compression_chunk=CHUNK,
                       huffman_table="shared").compress(raw.tobytes()))
    z = ZipNN(engine="numpy")
    after = z._retrieve_header(memoryview(comp))
    plan = decode.build_plan(memoryview(comp)[after:], 2, 1, 10, CHUNK, raw.size)
    assert plan.shared
    s0, ln = after + int(plan.starts[6]), int(plan.lens[6])
    for bit in range(8 * (ln // 2), 8 * (ln - 1)):
        bad = bytearray(comp)
        bad[s0 + bit // 8] ^= 1 << (bit % 8)
        try:
            ZipNN(engine="cuda", device="cpu").decompress(bytes(bad))
        except CorruptChunkError as exc:
            want = (exc.plane, exc.chunk, exc.stream)
            break
    else:
        pytest.fail("no rejected bit flip found")
    with pytest.raises(CorruptChunkError) as got:
        ZipNN(engine="cuda").decompress(bytes(bad))
    assert decode.last_timings["decoder"] == "huf_shared_decode"
    assert (got.value.plane, got.value.chunk, got.value.stream) == want
    assert want[2] == 2


def _etable(symbols):
    lengths, vals, _, _ = huf.build_shared_table(np.bincount(symbols, minlength=256))
    return torch.from_numpy(huf_enc.pack_etable(vals, lengths))


@pytest.mark.parametrize("schedule", ["warp", "lane"])
@pytest.mark.parametrize("codes", ["sampled", "all_8_bit", "all_1_bit"])
@pytest.mark.parametrize("seg", [0, 4, 60, 252, 508, 4096, 32768])
def test_huf_enc_kernel_matches_plain(card, seg, codes, schedule, monkeypatch):
    """K7 against its plain version with a warp per stream and with a lane
    per stream (``WARP_SYMBOLS`` forces the launch's schedule): streams at
    word offsets of every residue mod 4 and segments that are not a
    multiple of 16 bytes (word loads at the segment's ends), codes of 8
    bits (every tile fills its staging row) and of 1 bit, and under the
    sampled table a byte it cannot code in the first tile of one stream
    (its highest symbols), the last tile of another and a middle tile of a
    third."""
    monkeypatch.setattr(huf_enc, "WARP_SYMBOLS", 0 if schedule == "warp" else 1 << 30)
    rng = np.random.default_rng(seg + 7)
    n = max(16, min(300, (4 << 20) // max(seg, 1)))
    w = seg // 4
    syms = np.clip(rng.normal(120, 7, 4 * (n * w + 4)), 0, 250).astype(np.uint8)
    offs = [s * w + s % 4 for s in range(n)]
    if codes == "sampled":
        table = _etable(syms)
        assert int(table[255]) == 0
        for s, i in ((1, seg - 6), (2, 3), (3, seg // 2)):
            if 0 <= i < seg:
                syms[4 * offs[s] + i] = 255
    else:
        nb = 8 if codes == "all_8_bit" else 1
        vals = rng.permutation(256) if nb == 8 else np.arange(256) & 1
        table = torch.from_numpy(huf_enc.pack_etable(vals, np.full(256, nb)))
    words = torch.from_numpy(syms.view("<i4").copy())
    streams = torch.tensor(offs, dtype=torch.int64).flip(0)
    rows_p, bits_p = huf_enc.huf_shared_encode(words, table, seg, streams)
    rows_k, bits_k = huf_enc.huf_shared_encode(*_to((words, table), card), seg,
                                               streams.to(card))
    torch.cuda.synchronize()
    assert torch.equal(bits_k.cpu(), bits_p)
    if codes == "sampled" and seg >= 8:
        assert int((bits_p >> 30).sum()) >= 3
    nbytes = ((bits_p & 0x3FFFFFFF) + 7) // 8
    rk, rp = rows_k.cpu().numpy().view(np.uint8), rows_p.numpy().view(np.uint8)
    for s in range(n):
        assert bytes(rk[s, : nbytes[s]]) == bytes(rp[s, : nbytes[s]]), s


@pytest.mark.parametrize("width", [1, 3, 64, 32768])
def test_const_scan_kernel_matches_plain(card, width):
    rng = np.random.default_rng(width)
    rows = rng.integers(0, 1 << 32, (70, width), dtype=np.uint64).astype(np.uint32)
    for i, b in enumerate((0x00, 0xFF, 0x5A)):
        rows[i] = b * 0x01010101
    rows[3] = 0x77777777
    rows[3, -1] ^= 1 << 31  # differs only in its last byte
    t = torch.from_numpy(rows.view(np.int32))
    assert torch.equal(const_scan.const_scan_rows(t.to(card)).cpu(),
                       const_scan.const_scan_rows(t))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                                   torch.float32])
def test_shared_encode_on_card_matches_golden(card, dtype):
    """Host input (uploaded) and a CUDA tensor (read in place), both equal
    to the golden encoder's container."""
    raw = _raw(dtype, 9 * CHUNK + 6004, seed=8)
    x = torch.from_numpy(raw.copy()).view(dtype)
    want = bytes(ZipNN(input_format="torch", engine="numpy", compression_chunk=CHUNK,
                       huffman_table="shared").compress(x))
    z = ZipNN(input_format="torch", engine="cuda", compression_chunk=CHUNK,
              huffman_table="shared")
    kernels.reset_launches()
    assert bytes(z.compress(x)) == want
    assert encode.last_timings["upload_bytes"] == 9 * CHUNK
    assert bytes(z.compress(x.to(card))) == want
    assert encode.last_timings["encoder"] == "huf_shared_encode"
    assert encode.last_timings["upload_bytes"] == 0
    assert 0 < encode.last_timings["h2d_bytes"] < 9 * CHUNK // 8  # tables, indices
    assert kernels.launches["huf_shared_encode"] > 0 and kernels.launches["const_scan_rows"] > 0
    assert encode.kernel_ms()["huf_shared_encode"] > 0
    y = ZipNN(input_format="torch", engine="cuda").decompress(want)
    assert torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8))


@pytest.mark.parametrize("nbytes", [0, 2, 700, CHUNK + 2])
def test_shared_encode_on_card_short_inputs(card, nbytes):
    """No full chunk, or one: the tail cell on the host, K7/K8 on the rest."""
    # via int16: torch refuses a width-changing view of an empty tensor
    x = torch.from_numpy(_raw(torch.bfloat16, nbytes, seed=nbytes).view(np.int16).copy())
    x = x.view(torch.bfloat16)
    want = bytes(ZipNN(input_format="torch", engine="numpy", compression_chunk=CHUNK,
                       huffman_table="shared").compress(x))
    got = bytes(ZipNN(input_format="torch", engine="cuda", compression_chunk=CHUNK,
                      huffman_table="shared").compress(x.to(card)))
    assert got == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chunk", [64, 256])
def test_shared_encode_on_card_small_chunks(card, dtype, chunk):
    """Chunks below 512 bytes, read in place from a CUDA tensor, through
    K8 and K7, byte-identical to the golden encoder."""
    raw = _raw(dtype, 530 * chunk + 6, seed=chunk)
    x = torch.from_numpy(raw.copy()).view(dtype)
    want = bytes(ZipNN(input_format="torch", engine="numpy", compression_chunk=chunk,
                       huffman_table="shared").compress(x))
    kernels.reset_launches()
    got = bytes(ZipNN(input_format="torch", engine="cuda", compression_chunk=chunk,
                      huffman_table="shared").compress(x.to(card)))
    assert got == want
    assert encode.last_timings["upload_bytes"] == 0
    assert kernels.launches["huf_shared_encode"] > 0 and kernels.launches["const_scan_rows"] > 0


def test_shared_encode_on_card_uncodeable_cell(card):
    """>= 512 chunks (stride 8): a non-sampled chunk with an exponent byte
    no sampled chunk has stores raw; a constant cell on the hopeless plane
    stays RLE."""
    chunk = 1024
    vals = _raw(torch.bfloat16, 520 * chunk, seed=9).view(np.uint16).copy()
    vals.reshape(520, -1)[9, 5] = 0x7000        # exponent byte 0xE0 after rotation
    vals.reshape(520, -1)[13] = np.arange(512) % 64 << 7  # mantissa bytes all 0
    x = torch.from_numpy(vals.view(np.int16)).view(torch.bfloat16)
    want = bytes(ZipNN(input_format="torch", engine="numpy", compression_chunk=chunk,
                       huffman_table="shared").compress(x))
    got = bytes(ZipNN(input_format="torch", engine="cuda", compression_chunk=chunk,
                      huffman_table="shared").compress(x.to(card)))
    assert got == want
    z = ZipNN(engine="numpy")
    after = z._retrieve_header(memoryview(got))
    types, starts, _ = codec.parse_tables(memoryview(got)[after:], 2, 520)
    sizes = np.diff(starts, axis=1)
    assert types[1, 9] == 0 and types[1, 8] == 1
    assert types[0, 13] == 1 and sizes[0, 13] == 1


@pytest.mark.parametrize("chunk", [256, 4096, 262144])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hist_cells_kernel_matches_plain(card, dtype, chunk):
    """The per-cell histograms of split planes: the skewed bf16 exponent
    plane (one byte ~1/3 of the bytes), constant rows, and rows read at an
    odd word offset (word loads, no 16-byte path)."""
    n_chunks = max(3, min(64, (8 << 20) // chunk))
    raw = _raw(dtype, n_chunks * chunk, seed=chunk)
    gr = (2, 1) if dtype == torch.bfloat16 else (4, 1)
    words = torch.from_numpy(raw.view("<i4").copy()).view(n_chunks, chunk // 4)
    planes = transforms.split_device(words.to(card), gr[0], 10 if gr[0] == 2 else 220, gr[1])
    rows = planes.reshape(n_chunks * gr[0], -1)
    rows[1] = 0x3C3C3C3C
    got = hist.hist_cells(rows)
    assert torch.equal(got.cpu(), hist.hist_cells_plain(rows.cpu()))
    if dtype == torch.bfloat16:
        assert int(got[1::2].max(1).values.min()) > chunk // 2 // 5  # skewed
    shifted = torch.zeros(rows.numel() + 1, dtype=torch.int32, device=card)[1:]
    shifted.copy_(rows.reshape(-1))
    view = shifted.view(rows.shape)
    assert view.data_ptr() % 16 == 4
    assert torch.equal(hist.hist_cells(view).cpu(), got.cpu())


def _pc_tables(n_cells, seed):
    """A different table on every cell, codes of up to 8, 11 or 12 bits
    (geometric counts), and each cell's symbols drawn from its table."""
    rng = np.random.default_rng(seed)
    tabs, syms_of = [], []
    for i in range(n_cells):
        n_syms, bits = ((5, 8), (40, 11), (220, 12))[i % 3]
        syms = rng.permutation(256)[:n_syms]
        count = np.zeros(256, np.int64)
        count[syms] = np.maximum(1, (1 << 20) >> np.minimum(np.arange(n_syms), 40))
        lengths = huf.build_code_lengths(count, bits)
        vals = huf.canonical_values(lengths, int(lengths.max()))
        tabs.append(huf_enc.pack_pc_table(vals, lengths))
        syms_of.append(syms)
    return torch.from_numpy(np.stack(tabs)), syms_of


@pytest.mark.parametrize("schedule", ["warp", "lane"])
@pytest.mark.parametrize("seg", [4, 32, 60, 128, 512, 1024, 32768])
def test_huf_pc_encode_kernel_matches_plain(card, seg, schedule, monkeypatch):
    """The per-chunk K7 against its plain version under both schedules:
    a table per cell with codes of up to 12 bits, short streams (256 B to
    4 KB bf16 chunks give 32 to 512 symbols), and streams at word offsets
    of every residue mod 4 (odd word offsets)."""
    monkeypatch.setattr(huf_enc, "WARP_SYMBOLS", 0 if schedule == "warp" else 1 << 30)
    n_cells = max(3, min(96, (2 << 20) // seg))
    tables, syms_of = _pc_tables(n_cells, seed=seg)
    rng = np.random.default_rng(seg + 1)
    w = seg // 4
    syms = np.zeros(4 * (4 * n_cells * (w + 4) + 8), np.uint8)
    offs = []
    for s in range(4 * n_cells):
        o = s * (w + 4) + s % 4
        syms[4 * o : 4 * o + seg] = rng.choice(syms_of[s // 4], seg)
        offs.append(o)
    syms[4 * offs[2] : 4 * offs[2] + 3] = syms_of[0][-1]
    words = torch.from_numpy(syms.view("<i4").copy())
    streams = torch.tensor(offs, dtype=torch.int64)
    rows_p, bits_p = huf_enc.huf_pc_encode(words, tables, seg, streams)
    kernels.reset_launches()
    rows_k, bits_k = huf_enc.huf_pc_encode(*_to((words, tables), card), seg, streams.to(card))
    torch.cuda.synchronize()
    assert kernels.launches["huf_pc_encode"] == 1
    assert torch.equal(bits_k.cpu(), bits_p) and int((bits_p >> 30).sum()) == 0
    nbytes = ((bits_p & 0x3FFFFFFF) + 7) // 8
    assert int(nbytes.max()) > seg  # codes longer than 8 bits
    rk, rp = rows_k.cpu().numpy().view(np.uint8), rows_p.numpy().view(np.uint8)
    for s in range(4 * n_cells):
        assert bytes(rk[s, : nbytes[s]]) == bytes(rp[s, : nbytes[s]]), s


def _split_inputs(n_streams, seg, codes, seed):
    """Symbols, word offsets (every residue mod 4, so most streams start
    and end off 16-byte boundaries) and per-cell tables for E's split:
    ``mixed`` codes of up to 8, 11 or 12 bits; ``all_12_bit`` every symbol
    12 bits (the row's worst fill); ``one_bit`` a near-constant stream of
    1-bit codes (16 or 32 bits a lane; with 516 or 1 040 symbols the
    segment's last 4 words make a part of 16 bits of its own); ``uncoded``
    one symbol without a code in the middle of stream 0, so in one part
    only."""
    rng = np.random.default_rng(seed)
    n_cells = -(-n_streams // 4)
    if codes in ("mixed", "uncoded"):
        tables, syms_of = _pc_tables(n_cells, seed)
    else:
        lengths = np.zeros(256, np.int64)
        if codes == "all_12_bit":
            lengths[:] = 12
            vals = rng.permutation(4096)[:256]
            syms_of = [np.arange(256)] * n_cells
        else:
            lengths[[7, 9]] = 1
            vals = (np.arange(256) == 9).astype(np.int64)
            syms_of = [np.array([7] * 31 + [9])] * n_cells
        tables = torch.from_numpy(np.stack([huf_enc.pack_pc_table(vals, lengths)] * n_cells))
    w = seg // 4
    syms = np.zeros(4 * (n_streams * (w + 4) + 8), np.uint8)
    offs = []
    for s in range(n_streams):
        o = s * (w + 4) + s % 4
        syms[4 * o : 4 * o + seg] = rng.choice(syms_of[s // 4], seg)
        offs.append(o)
    if codes == "uncoded":
        uncoded = np.nonzero((tables[0].numpy().view(np.uint16) >> 12) == 0)[0]
        syms[4 * offs[0] + seg // 2 + 1] = uncoded[0]
    return (torch.from_numpy(syms.view("<i4").copy()), tables,
            torch.tensor(offs, dtype=torch.int64))


def _same_stream_bytes(rows_k, rows_p, bits):
    """Every row byte below ceil(bits / 8) of each stream equal."""
    nbytes = ((bits.to(torch.int64) & 0x3FFFFFFF) + 7) // 8
    width = int(nbytes.max()) if nbytes.numel() else 0
    keep = torch.arange(width) < nbytes[:, None]
    got = rows_k.cpu().view(torch.uint8)[:, :width][keep]
    return torch.equal(got, rows_p.view(torch.uint8)[:, :width][keep])


_SPLIT_CASES = {
    "1x32768": (1, 32768, "mixed"),
    "4x2048": (4, 2048, "mixed"),
    "16x32768": (16, 32768, "mixed"),  # a 1 MiB bf16 frame's exponent planes
    "4096x512": (4096, 512, "mixed"),
    "4x131072": (4, 131072, "mixed"),
    "4x2576": (4, 2576, "mixed"),  # 3 tiles of 1 024 symbols: no split of 2 or more divides them
    "4x8192_all_12_bit": (4, 8192, "all_12_bit"),
    "4x516_one_bit": (4, 516, "one_bit"),
    "4x1040_one_bit": (4, 1040, "one_bit"),  # the same on tiles of 1 024 symbols
    "1x32768_uncoded": (1, 32768, "uncoded"),
}


@pytest.mark.parametrize("parts", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_huf_pc_encode_split_matches_plain(card, case, parts, monkeypatch):
    """E with each stream split over ``parts`` warps (``huf_enc.PARTS``
    forces the split; None: the host's pick) against its plain version:
    every ``total_bits`` and every row byte below ceil(bits / 8)."""
    monkeypatch.setattr(huf_enc, "PARTS", parts)
    n_streams, seg, codes = _SPLIT_CASES[case]
    words, tables, streams = _split_inputs(n_streams, seg, codes, seed=seg + n_streams)
    rows_p, bits_p = huf_enc.huf_pc_encode(words, tables, seg, streams)
    kernels.reset_launches()
    rows_k, bits_k = huf_enc.huf_pc_encode(*_to((words, tables), card), seg, streams.to(card))
    torch.cuda.synchronize()
    assert kernels.launches["huf_pc_encode"] == 1
    assert torch.equal(bits_k.cpu(), bits_p)
    assert int((bits_p >> 30).sum()) == (1 if codes == "uncoded" else 0)
    if codes == "uncoded":
        assert int(bits_p[0]) >> 30 == 1
    if codes == "all_12_bit":
        assert torch.equal(bits_p, torch.full_like(bits_p, 12 * seg + 1))
    assert _same_stream_bytes(rows_k, rows_p, bits_p)


def test_huf_pc_encode_empty_launch(card):
    """No stream: nothing launched, empty outputs of the row width."""
    words = torch.zeros(64, dtype=torch.int32, device=card)
    tables = torch.zeros((0, 256), dtype=torch.int16, device=card)
    kernels.reset_launches()
    rows, bits = huf_enc.huf_pc_encode(words, tables, 32768,
                                       torch.zeros(0, dtype=torch.int64, device=card))
    assert rows.shape == (0, huf_enc.row_words(32768, huf_enc.PC_TMAX)) and bits.shape == (0,)
    assert kernels.launches["huf_pc_encode"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                                   torch.float32])
def test_pc_encode_on_card_matches_golden(card, dtype):
    """The default per-chunk profile from host input and from a CUDA
    tensor (read in place), equal to the golden container, through
    hist_cells and huf_pc_encode only."""
    raw = _raw(dtype, 9 * CHUNK + 6004, seed=12)
    x = torch.from_numpy(raw.copy()).view(dtype)
    want = bytes(ZipNN(input_format="torch", engine="numpy",
                       compression_chunk=CHUNK).compress(x))
    z = ZipNN(input_format="torch", engine="cuda", compression_chunk=CHUNK)
    assert bytes(z.compress(x)) == want
    kernels.reset_launches()
    assert bytes(z.compress(x.to(card))) == want
    assert encode.last_timings["encoder"] == "huf_pc_encode"
    assert encode.last_timings["upload_bytes"] == 0
    assert kernels.launches["hist_cells"] > 0 and kernels.launches["huf_pc_encode"] > 0
    assert kernels.launches["huf_shared_encode"] == 0
    assert kernels.launches["const_scan_rows"] == 0
    assert encode.kernel_ms()["huf_pc_encode"] > 0


@pytest.mark.parametrize("chunk", [1, 2])
def test_sub_word_chunks_on_card(card, chunk):
    """Chunks of 1 and 2 bytes decode on the card (K2 byte by byte), bf16
    and fp32, both profiles; they encode on the card too (the sub-word
    route), read in place from the CUDA tensor, equal to the golden
    encoder's container."""
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(_raw(dtype, 1000, seed=chunk).copy()).view(dtype)
        for profile in ("per_chunk", "shared"):
            comp = ZipNN(input_format="torch", engine="cuda", compression_chunk=chunk,
                         huffman_table=profile).compress(x.to(card))
            assert encode.last_timings["encoder"] == "sub_word"
            assert encode.last_timings["upload_bytes"] == 0
            assert bytes(comp) == bytes(ZipNN(input_format="torch", engine="numpy",
                                              compression_chunk=chunk,
                                              huffman_table=profile).compress(x))
            kernels.reset_launches()
            y = ZipNN(input_format="torch", engine="cuda").decompress(comp)
            assert kernels.launches["combine_cells"] == 1
            assert torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8))


@pytest.mark.parametrize("profile", ["per_chunk", "shared"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encode_on_card_takes_native_plan_and_splice(card, dtype, profile, monkeypatch):
    """Both profiles' encode from a CUDA tensor in several batches: the
    per-chunk tables come from ``native.build_ctables`` (one call a batch),
    every batch's cells are written on the card by ``splice_cells`` (one
    launch a batch), the native core splices only the tail's, and the
    container equals the golden encoder's."""
    calls = {"build_ctables": 0, "splice_cells": 0}
    for name in calls:
        fn = getattr(native, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(native, name, counted)
    monkeypatch.setattr(encode, "batch_chunks", lambda cs, stride: 3 * stride)
    raw = _raw(dtype, 30 * 4096 + 6, seed=21)
    x = torch.from_numpy(raw.copy()).view(dtype)
    kw = dict(input_format="torch", compression_chunk=4096, huffman_table=profile)
    kernels.reset_launches()
    got = ZipNN(engine="cuda", **kw).compress(x.to(card))
    assert bytes(got) == bytes(ZipNN(engine="numpy", **kw).compress(x))
    batches = encode.last_timings["batches"]
    assert batches >= 2 and encode.last_timings["upload_bytes"] == 0
    assert kernels.launches["splice_cells"] == batches
    assert calls["splice_cells"] == 1  # the tail
    assert calls["build_ctables"] == (batches if profile == "per_chunk" else 0)


# ---------------------------------------------------------------------------
# the pipelined decode's staging, and io.serving.ShardDecoder
# ---------------------------------------------------------------------------

def _shard_blobs(k, nbytes, seed, **kw):
    raws = [_raw(torch.bfloat16, nbytes + 2 * i, seed + i).tobytes() for i in range(k)]
    return raws, [bytes(ZipNN(engine="numpy", compression_chunk=CHUNK, **kw).compress(r))
                  for r in raws]


class _H2DCopies(torch.utils._python_dispatch.TorchDispatchMode):
    """Records, for every host-to-card copy, whether its source is pinned."""

    def __init__(self):
        super().__init__()
        self.pinned = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.copy_.default:
            dst, src = args[0], args[1]
            if dst.is_cuda and src.device.type == "cpu":
                self.pinned.append(src.is_pinned())
        elif func is torch.ops.aten._to_copy.default:
            dev = kwargs.get("device")
            if args[0].device.type == "cpu" and dev is not None and torch.device(dev).type == "cuda":
                self.pinned.append(args[0].is_pinned())
        return func(*args, **kwargs)


def test_decode_uploads_only_from_pinned_staging(card, monkeypatch):
    from zipnn_tpu_torch.io.serving import ShardDecoder
    from zipnn_tpu_torch.ops import staging

    monkeypatch.setattr(decode, "BATCH_BYTES", 4 * CHUNK)
    raws, blobs = _shard_blobs(2, 9 * CHUNK + 6002, seed=30)
    dec = ShardDecoder(to_device=True)
    with _H2DCopies() as seen:
        assert bytes(ZipNN(engine="cuda").decompress(blobs[0])) == raws[0]
        t = dict(decode.last_timings)
        outs = dec.decompress_all(blobs)
    assert [o.cpu().numpy().tobytes() for o in outs] == raws
    assert len(seen.pinned) >= 2 * 3 and all(seen.pinned)
    pool = staging.pool(card)
    bufs = pool.free + [b for b, _ in pool.busy]
    assert bufs and all(b.is_pinned() for b in bufs)
    for t in (t, *dec.timings):
        assert t["stage_s"] > 0 and t["upload_s"] > 0 and t["plan_s"] > 0


def test_serving_iter_repeats_bit_exact_at_small_batches(card, monkeypatch):
    """50 loads of 3 shards through many 64 KB batches, pieces of 16 KB
    and a pool of 4 pieces: every event, wait and buffer reuse is
    exercised many times over."""
    from zipnn_tpu_torch.io.serving import ShardDecoder
    from zipnn_tpu_torch.ops import staging

    monkeypatch.setattr(decode, "BATCH_BYTES", 64 << 10)
    monkeypatch.setattr(staging, "PIECE_BYTES", 16 << 10)
    monkeypatch.setattr(staging, "POOL_BYTES", 64 << 10)
    monkeypatch.setattr(staging, "_pools", {})
    raws, blobs = _shard_blobs(3, 40 * CHUNK + 6002, seed=40)
    dec = ShardDecoder(to_device=True)
    for _ in range(50):
        got = list(dec.decompress_iter(blobs))
        assert all(g.is_cuda for g in got)
        assert [g.cpu().numpy().tobytes() for g in got] == raws
    assert staging.pool(card).held <= 64 << 10


def test_serving_deferred_corruption_on_card(card):
    from zipnn_tpu_torch.io.serving import ShardDecoder

    raws, blobs = _shard_blobs(3, 4 * CHUNK, seed=50)
    z = ZipNN(engine="numpy")
    after = z._retrieve_header(memoryview(blobs[1]))
    plan = decode.build_plan(memoryview(blobs[1])[after:], 2, 1, 10, CHUNK, len(raws[1]))
    s0, ln = after + int(plan.starts[6]), int(plan.lens[6])
    for bit in range(8 * (ln // 2), 8 * (ln - 1)):
        bad = bytearray(blobs[1])
        bad[s0 + bit // 8] ^= 1 << (bit % 8)
        try:
            ZipNN(engine="cuda").decompress(bytes(bad))
        except CorruptChunkError as exc:
            want = (exc.plane, exc.chunk, exc.stream, str(exc))
            break
    else:
        pytest.fail("no rejected bit flip found")
    for dec in (ShardDecoder(to_device=True), ShardDecoder(as_numpy=True)):
        with pytest.raises(CorruptChunkError) as got:
            dec.decompress_all([blobs[0], bytes(bad), blobs[2]])
        e = got.value
        assert (e.plane, e.chunk, e.stream, str(e)) == want
    outs = ShardDecoder(to_device=True).decompress_all(blobs)
    assert [o.cpu().numpy().tobytes() for o in outs] == raws


def test_serving_outputs_on_card_and_pool_bounded(card):
    """A 20-shard load (both profiles, one shard with no full chunk)
    through decompress_iter, decompress_all and replayed staged groups:
    outputs live on the card, and the pool's pinned bytes stay under its
    bound.  The shared-table shard decodes by K6 alone, and by K1 in the
    staged groups' launch set, which covers all 20."""
    from zipnn_tpu_torch.io.serving import ShardDecoder
    from zipnn_tpu_torch.ops import staging

    raws, blobs = _shard_blobs(18, 64 * CHUNK + 6, seed=60)
    r2, b2 = _shard_blobs(1, 8 * CHUNK, seed=80, huffman_table="shared")
    r3, b3 = _shard_blobs(1, 8192, seed=90)
    raws, blobs = raws + r2 + r3, blobs + b2 + b3
    dec = ShardDecoder(to_device=True)
    got = list(dec.decompress_iter(blobs))
    assert all(g.is_cuda and g.dtype == torch.uint8 for g in got)
    assert [g.cpu().numpy().tobytes() for g in got] == raws
    assert len(dec.timings) == 20 and all(t["upload_s"] >= 0 for t in dec.timings)
    assert sum(t["upload_s"] for t in dec.timings) > 0
    kernels.reset_launches()
    assert [g.cpu().numpy().tobytes() for g in dec.decompress_all(blobs)] == raws
    assert kernels.launches["huf_shared_decode"] > 0
    units = dec.stack_groups([dec.stage(b) for b in blobs])
    for _ in range(2):
        kernels.reset_launches()
        got = dec.decompress_groups(units)
        assert [g.cpu().numpy().tobytes() for g in got] == raws
        assert kernels.launches["huf_shared_decode"] == 0
        assert kernels.launch_sets == {"sets": 1, "containers": 20}
    pool = staging.pool(card)
    assert pool.held <= staging.POOL_BYTES


def test_standalone_device_inputs_order_later_kernels(card, monkeypatch):
    """Inputs uploaded ahead (``stage``) and launched at once
    (``start_staged``): each batch's kernels read the uploaded bytes, not
    bytes still in flight on the copy stream."""
    from zipnn_tpu_torch.ops import staging

    monkeypatch.setattr(decode, "BATCH_BYTES", 16 * CHUNK)
    monkeypatch.setattr(staging, "PIECE_BYTES", 16 << 10)
    monkeypatch.setattr(staging, "_pools", {})
    raws, blobs = _shard_blobs(1, 64 * CHUNK, seed=70)
    z = ZipNN(engine="numpy")
    after = z._retrieve_header(memoryview(blobs[0]))
    payload = memoryview(blobs[0])[after:]
    for _ in range(20):
        st = decode.stage(payload, 2, 1, 10, CHUNK, len(raws[0]), device=card)
        assert len(st.events) == 4
        out = decode.finish(decode.start_staged(st))
        assert out.cpu().numpy().tobytes() == raws[0]


def test_staged_decode_records_events_only_for_the_caller(card):
    """``decode.start_staged`` records no CUDA events of its own (and
    ``kernel_ms`` then reads 0); inside a caller's ``kernels.recording()``
    a stack of 3 containers of one geometry lands in the caller's list as
    one launch set: one K1 and one grouped K2 launch."""
    from zipnn_tpu_torch.io.serving import ShardDecoder

    raws, blobs = _shard_blobs(3, 8 * CHUNK + 6, seed=95)
    dec = ShardDecoder(to_device=True)
    staged = [dec.stage(b) for b in blobs]
    for st, raw in zip(staged, raws):
        run = decode.start_staged(st.staged)
        assert "events" not in run.timings
        assert decode.finish(run).cpu().numpy().tobytes() == raw
        assert decode.kernel_ms() == {"huf_pc_decode": 0.0, "combine_cells": 0.0}
    kernels.reset_launches()
    with kernels.recording() as events:
        outs = dec.decompress_stacked(staged)
    assert [o.cpu().numpy().tobytes() for o in outs] == raws
    assert [name for name, _, _ in events] == ["huf_pc_decode", "combine_cells_grouped"]
    assert kernels.launch_sets == {"sets": 1, "containers": 3}
    assert all(ms > 0 for ms in kernels.elapsed_ms(events).values())


def test_traced_stacked_decode_shares_the_card_clock(card, tmp_path):
    """In a traced ``decompress_stacked`` of 3 containers of one geometry
    (one launch set) the set's kernel launches (the host calls the
    profiler ties to its K1 and grouped K2 by correlation) lie inside the
    set's ``znn:decode:enqueue`` span, and each kernel starts on the card
    after its span starts: the program's spans and the device's events
    share one clock.  The grouped K2's device name holds
    ``combine_cells``, which the benchmark's K2 roofline reads."""
    from zipnn_tpu_torch.io.serving import ShardDecoder

    raws, blobs = _shard_blobs(3, 8 * CHUNK + 6, seed=97)
    dec = ShardDecoder(to_device=True)
    stk = dec.stack([dec.stage(b) for b in blobs])
    dec.decompress_stacked(stk)
    torch.cuda.synchronize()
    with stats.trace(str(tmp_path)):
        outs = dec.decompress_stacked(stk)
        torch.cuda.synchronize()
    assert [o.cpu().numpy().tobytes() for o in outs] == raws
    (path,) = tmp_path.glob("*.pt.trace.json")
    xs = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                   if e.get("cat") == "user_annotation" and e["name"] == "znn:decode:enqueue")
    kern = [e for e in xs if e.get("cat") == "kernel"
            and ("huf_pc_decode" in e["name"] or "combine_cells" in e["name"])]
    host = {e["args"]["correlation"]: e for e in xs
            if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    assert len(spans) == 1 and len(kern) == 2, sorted({e.get("cat") for e in xs})
    assert any("combine_cells_grouped" in k["name"] for k in kern), [k["name"] for k in kern]
    per = [0]
    for k in kern:
        h = host[k["args"]["correlation"]]
        assert "LaunchKernel" in h["name"], h["name"]
        (i,) = [j for j, (a, b) in enumerate(spans) if a <= h["ts"] and h["ts"] + h["dur"] <= b]
        per[i] += 1
        assert k["ts"] >= spans[i][0]
    assert per == [2]


def test_stacked_mix_on_card_equals_each_member_alone(card, monkeypatch):
    """``tests/test_torch_launch_sets.py``'s mix on the card: sets closed on
    geometry and on size, both K1 schedules in one set, a shared-table
    member through K1, the member over ``BATCH_BYTES`` cut into pieces in
    two sets, the 2-byte chunks a set of their own (K2 by
    ``combine_cells``), the lossy member in a set, the empty one in none;
    every output equal to the original bytes and the member's own
    ``decode.start``, twice; the launches counted; no member holding its
    descriptors, and each member's stack of one equal too."""
    from test_torch_launch_sets import (SMALL_BATCH, as_bytes, held_on_card, mixed_unit,
                                        stage_mixed)
    from zipnn_tpu_torch.io.serving import ShardDecoder

    monkeypatch.setattr(decode, "BATCH_BYTES", SMALL_BATCH)
    names, inputs, blobs = mixed_unit()
    dec = ShardDecoder(to_device=True)
    staged, alone = stage_mixed(dec, blobs)
    for name, data, got in zip(names, inputs, alone):
        if data is not None:
            assert got == data, name
    stk = dec.stack(staged)
    sets = stk.unit.sets
    assert any([g for g, _ in ls.k1] == [1, 32] for ls in sets)
    in_sets = [[names[m] for m, _, _ in ls.pieces] for ls in sets]
    assert sum(ms.count("bf16_big") for ms in in_sets) == 2
    assert "empty" not in sum(in_sets, []) and ["sub_word"] in in_sets
    assert any("lossy" in ms for ms in in_sets)
    grouped = [ls for ls in sets if ls.k2[0] is combine.combine_cells_grouped]
    assert len(grouped) == len(sets) - 1
    for _ in range(2):
        kernels.reset_launches()
        outs = dec.decompress_stacked(stk)
        assert all(o.is_cuda for o in outs)
        assert [as_bytes(o) for o in outs] == alone
    assert kernels.launch_sets == {"sets": len(sets), "containers": sum(ls.n for ls in sets)}
    assert kernels.launches["combine_cells_grouped"] == len(grouped)
    assert kernels.launches["combine_cells"] == 1
    assert kernels.launches["huf_pc_decode"] == sum(len(ls.k1) for ls in sets)
    assert kernels.launches["huf_shared_decode"] == 0
    # no member holds its descriptors on the card; each decodes alone (a
    # stack of one) after the stack moved its payload
    assert all(held_on_card(st) in ([], ["payload"]) for st in staged)
    for m, st in enumerate(staged):
        assert as_bytes(dec.start_staged(st).finish()) == alone[m], names[m]


@pytest.mark.parametrize("num_buf,byte_reorder,bit_reorder", [
    (1, 0, 0), (2, 10, 1), (2, 1, 1), (2, 8, 0), (4, 220, 1), (4, 220, 0)])
@pytest.mark.parametrize("chunk", [64, 1024])
def test_combine_grouped_kernel_matches_combine_cells(card, num_buf, byte_reorder,
                                                      bit_reorder, chunk):
    """``combine_cells_grouped`` on the card against ``combine_cells`` on the
    card, member by member: ragged last chunks, members at 256-byte
    offsets of one output, Huffman rows at byte offsets of one symbol
    buffer; each member's padding up to its next word is zero."""
    from test_torch_launch_sets import grouped_case

    sizes = (5 * chunk + 44, chunk, 7 * chunk + 4, 45)
    payload, hsym, members, grouped, n_out = grouped_case(num_buf, byte_reorder, 12,
                                                          chunk=chunk, sizes=sizes)
    payload, hsym = payload.to(card), hsym.to(card)
    out = torch.full((n_out,), 0xA5, dtype=torch.uint8, device=card)
    kernels.reset_launches()
    combine.combine_cells_grouped(payload, hsym, *(t.to(card) for t in grouped), 1, chunk,
                                  num_buf, byte_reorder, bit_reorder, out)
    assert kernels.launches["combine_cells_grouped"] == 1
    plain = torch.full((n_out,), 0xA5, dtype=torch.uint8)
    combine.combine_cells_grouped(payload.cpu(), hsym.cpu(), *grouped, 1, chunk, num_buf,
                                  byte_reorder, bit_reorder, plain)
    for off, total, kinds, srcs, sym_off, row in members:
        own = torch.full((-(-total // 4) * 4,), 0x5A, dtype=torch.uint8, device=card)
        combine.combine_cells(payload, hsym[sym_off:].contiguous(),
                              torch.from_numpy(kinds).to(card), torch.from_numpy(srcs).to(card),
                              row, chunk, total, num_buf, byte_reorder, bit_reorder, own)
        got = out[off : off + own.numel()].cpu()
        assert torch.equal(got, own.cpu()), (off, total)
        assert torch.equal(got, plain[off : off + own.numel()]), (off, total)


# ---------------------------------------------------------------------------
# the checkpoint save: splice_cells, staging.download, io.serving.ShardEncoder
# ---------------------------------------------------------------------------

def _random_cells(rng, n, planes, rows, hpool_n):
    """``n`` cells of every kind behind each other from byte 3 of the
    output (so at every alignment), 1-byte raw cells and 1-byte streams
    among them; the output buffer's size."""
    pw, rw = planes.shape[1] * 4, rows.shape[1] * 4
    kind = rng.integers(0, 3, n)
    huf = kind == 2
    size = np.where(kind == 1, 1, rng.integers(1, pw + 1, n))
    size[::7] = 1
    sb = rng.integers(1, rw + 1, (n, 4))
    sb[::5, 1] = 1
    hlen = np.where(huf, rng.integers(1, 40, n), 0)
    size = np.where(huf, hlen + 6 + sb.sum(axis=1), size)
    cells = np.zeros((n, splice.FIELDS), np.int64)
    cells[:, splice.DST] = 3 + np.cumsum(size) - size
    cells[:, splice.INFO] = splice.info(size, kind, huf.astype(int), hlen)
    src = np.where(huf, rng.integers(0, rows.shape[0] - 3, n), rng.integers(0, planes.shape[0], n))
    cells[:, splice.SRC] = splice.src(src, np.where(huf, rng.integers(0, hpool_n - 40, n), 0))
    cells[:, splice.SB] = splice.pack_sb(np.where(huf[:, None], sb, 0))
    return cells, int(size.sum()) + 3 + 13


@pytest.mark.parametrize("pw,rw", [(4, 4), (260, 37), (32768, 8193)])
def test_splice_cells_kernel_matches_plain(card, pw, rw):
    """Random cells (every alignment of destination and source, 1-byte
    cells and streams) against the plain version; bytes between and around
    the cells keep the buffer's fill."""
    rng = np.random.default_rng(pw)
    n = 300 if pw < 32768 else 40
    planes = torch.from_numpy(rng.integers(0, 256, (n, pw * 4), dtype=np.uint8)).view(torch.int32)
    rows = torch.from_numpy(rng.integers(0, 256, (4 * n, rw * 4), dtype=np.uint8)).view(torch.int32)
    hpool = torch.from_numpy(rng.integers(0, 256, 4096 + 13, dtype=np.uint8))
    cells, total = _random_cells(rng, n, planes, rows, hpool.numel())
    want = torch.full((total,), 0xAB, dtype=torch.uint8)
    splice.splice_cells_plain(want, cells, [planes, rows], hpool)
    got = torch.full((total,), 0xAB, dtype=torch.uint8, device=card)
    kernels.reset_launches()
    splice.splice_cells(got, cells, [planes.to(card), rows.to(card)], hpool.to(card))
    torch.cuda.synchronize()
    assert kernels.launches["splice_cells"] == 1
    assert torch.equal(got.cpu(), want)
    bad = cells.copy()
    bad[0, splice.DST] = total
    with pytest.raises(ValueError, match="outside"):
        splice.splice_cells(got, bad, [planes.to(card), rows.to(card)], hpool.to(card))


@pytest.mark.parametrize("pinned", [False, True], ids=["pageable", "pinned"])
def test_download_through_small_pieces(card, monkeypatch, pinned):
    """Ranges at odd offsets both sides through 16 KB pieces and a 64 KB
    pool (pageable destination), or one DMA a range (page-locked); every
    piece back in the pool, the pool within its bound."""
    monkeypatch.setattr(staging, "PIECE_BYTES", 16 << 10)
    monkeypatch.setattr(staging, "POOL_BYTES", 64 << 10)
    monkeypatch.setattr(staging, "_pools", {})
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.integers(0, 256, 300_001, dtype=np.uint8)).to(card)
    ranges = [(0, 7, 1), (5, 20, 100_003), (100_013, 100_100, 70_000), (170_013, 170_200, 129_988)]
    for rep in range(20):
        dst = torch.zeros(300_300, dtype=torch.uint8, pin_memory=pinned)
        want = np.zeros(300_300, np.uint8)
        host = src.cpu().numpy()
        for s, d, n in ranges:
            want[d : d + n] = host[s : s + n]
        src.add_(1)  # queued before the download: the copy stream must wait for it
        for s, d, n in ranges:
            want[d : d + n] += 1
        t = {}
        staging.download(staging.pool(card), src, dst if pinned else dst.numpy(), ranges, t,
                         label="encode")
        assert np.array_equal(dst.numpy(), want), rep
        assert t["download_s"] > 0 and (t["unstage_s"] == 0) == pinned
    p = staging.pool(card)
    assert p.held <= 64 << 10 and not any(not e.query() for _, e in p.busy)


def _save_inputs(k, nbytes, seed):
    return [torch.from_numpy(_raw(torch.bfloat16, nbytes + 2 * 1024 * i, seed + i).copy())
            .view(torch.bfloat16) for i in range(k)]


@pytest.mark.parametrize("profile", ["per_chunk", "shared"])
def test_multi_batch_encode_on_card(card, monkeypatch, profile):
    monkeypatch.setattr(encode, "BATCH_BYTES", 5 * CHUNK)
    x = _save_inputs(1, 41 * CHUNK + 6002, seed=31)[0]
    kw = dict(input_format="torch", compression_chunk=CHUNK, huffman_table=profile)
    kernels.reset_launches()
    got = ZipNN(engine="cuda", **kw).compress(x.to(card))
    t = dict(encode.last_timings)
    assert t["batches"] == 9 and kernels.launches["splice_cells"] == 9
    assert t["download_s"] > 0 and t["d2h_bytes"] >= len(got) - 8 * CHUNK
    assert bytes(got) == bytes(ZipNN(engine="numpy", **kw).compress(x))


def test_pipelined_saves_repeat_byte_identical(card, monkeypatch):
    """50 saves of 3 tensors, both profiles, through 64 KB batches, 16 KB
    pieces and a 64 KB pool, each container equal to its own
    ``ZipNN.compress``."""
    from zipnn_tpu_torch.io.serving import ShardEncoder

    monkeypatch.setattr(encode, "BATCH_BYTES", 4 * CHUNK)
    monkeypatch.setattr(staging, "PIECE_BYTES", 16 << 10)
    monkeypatch.setattr(staging, "POOL_BYTES", 64 << 10)
    monkeypatch.setattr(staging, "_pools", {})
    xs = [x.to(card) for x in _save_inputs(3, 20 * CHUNK + 6002, seed=41)]
    for profile in ("per_chunk", "shared"):
        z = ZipNN(input_format="torch", engine="cuda", compression_chunk=CHUNK,
                  huffman_table=profile)
        want = [z.compress(x) for x in xs]
        enc = ShardEncoder(z)
        for rep in range(25):
            assert enc.compress_all(xs) == want, (profile, rep)
    assert staging.pool(card).held <= 64 << 10


def test_pool_staging_views_hold_for_two_yields(card, monkeypatch):
    """Page-locked pooled containers: container i is intact while
    containers i + 1 and i + 2 are handed out, and the fetch went straight
    into it (no host copies out of staging pieces)."""
    from zipnn_tpu_torch.io import serving

    monkeypatch.setattr(serving, "_out_pool", [])
    xs = [x.to(card) for x in _save_inputs(6, 8 * CHUNK + 2, seed=51)]
    z = ZipNN(input_format="torch", engine="cuda", compression_chunk=CHUNK)
    want = [z.compress(x) for x in xs]
    enc = serving.ShardEncoder(z, pool_staging=True)
    views = []
    for i, v in enumerate(enc.compress_iter(xs)):
        views.append(v)
        for j in range(max(0, i - 2), i + 1):
            assert bytes(views[j]) == want[j], (i, j)
    assert all(t["unstage_s"] == 0 and t["download_s"] > 0 for t in enc.timings)
    assert all(b.is_pinned() for b in serving._out_pool + enc._held)


@pytest.mark.parametrize("profile", ["per_chunk", "shared"])
def test_embed_tokens_width_in_two_batches(card, monkeypatch, profile):
    """Llama-3-8B's ``embed_tokens`` (128256 x 4096 bf16, 1 GiB): two 512
    MiB batches, whose plane regions wait on the card until both are
    decided; the container equals the one-batch encode's and decodes back
    bit-exact."""
    gen = torch.Generator(device=card).manual_seed(7)
    x = (torch.randn((128256, 4096), generator=gen, device=card) * 0.05).to(torch.bfloat16)
    z = ZipNN(input_format="torch", engine="cuda", huffman_table=profile)
    kernels.reset_launches()
    two = z.compress(x)
    assert encode.last_timings["batches"] == 2 and kernels.launches["splice_cells"] == 2
    monkeypatch.setattr(encode, "BATCH_BYTES", 2 << 30)
    one = z.compress(x)
    assert encode.last_timings["batches"] == 1
    assert two == one
    y = ZipNN(input_format="torch", engine="cuda").decompress(two)
    assert torch.equal(y.view(torch.int16), x.view(torch.int16))


def _lossy_fp32(shape, seed):
    """An fp32 tensor of N(0, 0.05) and its lossy INTEGER container (int32
    planes, no sign rotation), from the golden encoder."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(np.float32))
    c = bytes(ZipNN(input_format="torch", engine="numpy", lossy_compressed_type="integer",
                    compression_chunk=CHUNK).compress(x))
    assert (c[5], c[6], c[12]) == (220, 0, 1)
    return x, c


def test_combine_4_planes_without_rotation_matches_plain(card):
    """K2 at 4 planes with ``bit_reorder`` 0 (the lossy int32 container)
    against its plain version, on every batch of a multi-chunk container."""
    x, c = _lossy_fp32((40, 1000), seed=60)
    z = ZipNN(engine="cuda")
    after = z._retrieve_header(memoryview(c))
    assert (z._bit_reorder, z._byte_reorder) == (0, 220)
    plan = decode.build_plan(memoryview(c)[after:], 4, 0, 220, CHUNK, z.original_len)
    dv = decode.DeviceInputs(plan, card)
    ints = (x * float(2**27)).to(torch.int32).view(torch.uint8).reshape(-1)
    for i, (lo, hi) in enumerate(dv.batches):
        torch.cuda.current_stream(card).wait_event(dv.upload(i))
        _, fn, args_of = dv.decoder()
        sym, _ = fn(*args_of(lo, hi))
        k2a = dv.k2_args(lo, hi, sym)
        n = -(-k2a[6] // 4) * 4
        out_k = torch.empty(n, dtype=torch.uint8, device=card)
        out_p = torch.empty(n, dtype=torch.uint8, device=card)
        combine.combine_cells(*k2a, out_k)
        combine.combine_cells_plain(*k2a, out_p)
        assert torch.equal(out_k, out_p)
        assert torch.equal(out_k[: k2a[6]].cpu(), ints[lo * CHUNK : lo * CHUNK + k2a[6]])


def test_lossy_round_trip_on_card(card):
    x, c = _lossy_fp32((64, 1000), seed=61)
    kw = {"input_format": "torch", "lossy_compressed_type": "integer",
          "compression_chunk": CHUNK}
    assert bytes(ZipNN(engine="cuda", **kw).compress(x.to(card))) == c
    kernels.reset_launches()
    y = ZipNN(input_format="torch", engine="cuda").decompress(c)
    assert kernels.launches["combine_cells"] > 0
    want = ZipNN(input_format="torch", engine="numpy").decompress(c)
    assert y.is_cuda and y.dtype == torch.float32 and torch.equal(y.cpu(), want)
    # one step (2**-27) of truncation, and up to two more from float32's
    # rounding of integers below 2**26 (|x| < 0.5)
    assert float((y.cpu() - x).abs().max()) <= 2.0 ** -25


def test_streaming_frames_decode_together_on_card(card):
    """300 frames of 4 KB at 2 KB chunks: one container's decode on the
    card, equal to the host engines', with fewer K1 launches than frames."""
    rng = np.random.default_rng(62)
    vals = (rng.standard_normal(300 * 2048 - 700) * 0.05).astype(np.float32)
    data = ((vals.view(np.uint32) >> 16).astype("<u2")).tobytes()
    kw = {"is_streaming": True, "streaming_chunk": 4096, "compression_chunk": 2048}
    c = bytes(ZipNN(engine="numpy", **kw).compress(data))
    assert bytes(ZipNN(engine="cuda", **kw).compress(data)) == c
    kernels.reset_launches()
    got = ZipNN(engine="cuda", is_streaming=True).decompress(c)
    assert decode.last_timings["frames"] == 300
    assert 0 < kernels.launches["huf_pc_decode"] < 300
    assert got == data == bytes(ZipNN(engine="native", is_streaming=True).decompress(c))


def _safetensors_file(path, tensors, metadata):
    """The safetensors layout (8-byte header length, JSON header padded to
    8 bytes, data), written here: this file does not import safetensors."""
    import json
    import struct

    header, off = {}, 0
    for name, (dtype, t) in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": dtype, "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    header["__metadata__"] = metadata
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text)
        for _, t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())


def test_stream_reader_get_tensor_onto_card(card, tmp_path):
    import json

    from zipnn_tpu_torch.io.streaming import METADATA_KEY, SafetensorsStreamReader

    g = torch.Generator().manual_seed(63)
    w = (torch.randn(300, 257, generator=g) * 0.05).to(torch.bfloat16)
    blob = ZipNN(input_format="torch", engine="numpy").compress(w)
    tensors = {"w": ("U8", torch.from_numpy(np.frombuffer(blob, np.uint8).copy())),
               "ids": ("I64", torch.arange(10))}
    path = str(tmp_path / "m.znn.safetensors")
    _safetensors_file(path, tensors, {"format": "pt", METADATA_KEY: json.dumps(
        {"w": {"dtype": "bfloat16", "shape": "[300, 257]"}})})
    r = SafetensorsStreamReader(path)
    kernels.reset_launches()
    got = r.get_tensor("w", device=card)
    assert kernels.launches["combine_cells"] > 0
    assert got.is_cuda and got.dtype == torch.bfloat16 and torch.equal(
        got.cpu().view(torch.int16), w.view(torch.int16))
    host = r.get_tensor("w")
    assert host.device.type == "cpu" and torch.equal(host.view(torch.int16), w.view(torch.int16))
    assert torch.equal(r.load_shard(device=card)["ids"].cpu(), torch.arange(10))


def test_cli_file_roundtrip_on_card(card, tmp_path):
    """``compress_file`` on its default engine (cuda, on the card) writes
    engine native's file; ``decompress_file`` on the card gives it back,
    its frames decoded together."""
    from zipnn_tpu_torch.cli import compress_file, decompress_file

    rng = np.random.default_rng(71)
    data = (_raw(torch.bfloat16, 3 << 20, 71).tobytes()
            + rng.integers(0, 256, 1001, np.uint8).tobytes())
    src = tmp_path / "w.bin"
    src.write_bytes(data)
    compress_file.main([str(src), "--force"])
    got = (tmp_path / "w.bin.znn").read_bytes()
    compress_file.main([str(src), "--force", "--engine", "native"])
    assert got == (tmp_path / "w.bin.znn").read_bytes()
    src.unlink()
    kernels.reset_launches()
    decompress_file.main([str(tmp_path / "w.bin.znn"), "--force"])
    assert 0 < kernels.launches["huf_pc_decode"] < 4  # 4 frames, one run
    assert src.read_bytes() == data


def test_trace_of_card_decode_lists_kernels(card, tmp_path):
    """``stats.trace`` of a decode on the card holds K1's and K2's kernels
    and the decoder's ``znn:`` spans."""
    from zipnn_tpu_torch import stats

    x = torch.from_numpy(_raw(torch.bfloat16, 4 << 20, 72).view(np.uint16).copy())
    comp = ZipNN(input_format="torch", engine="numpy").compress(x.view(torch.bfloat16))
    z = ZipNN(input_format="torch")
    z.decompress(comp)  # warm
    with stats.trace(str(tmp_path)) as prof:
        y = z.decompress(comp)
        torch.cuda.synchronize()
    assert torch.equal(y.cpu().view(torch.uint16), x)
    keys = {e.key for e in prof.key_averages()}
    for name in ("huf_pc_decode_kernel", "combine_cells_kernel"):
        assert any(name in k for k in keys), name
    for span in ("decode:plan", "decode:plan-tables", "decode:upload", "decode:stage"):
        assert f"znn:{span}" in keys, span


@pytest.mark.parametrize("profile", ["per_chunk", "shared"])
@pytest.mark.parametrize("dtype,chunk", [(torch.bfloat16, 30), (torch.bfloat16, 1002),
                                         (torch.float32, 52), (torch.float32, 100),
                                         (torch.float16, 30)])
def test_sub_word_planes_coded_on_card(card, dtype, chunk, profile):
    """Planes that are not whole words but hold 12 bytes or more, encoded
    from a CUDA tensor (split and RLE check on the card, the cells coded by
    the host's encoders): equal to the port's golden encoder, and decoded
    back on the card."""
    raw = _raw(dtype, 520 * chunk + 6, chunk).copy()
    raw[3 * chunk : 9 * chunk] = 0x3C
    nb, br = {torch.float32: (4, 220)}.get(dtype, (2, 10))
    shared = profile == "shared"
    got = codec.compress_payload(torch.from_numpy(raw).to(card), nb, 1, br, chunk, engine="cuda",
                                 device=card, check_th_after_percent=10, shared_tables=shared)
    assert encode.last_timings["encoder"] == "sub_word_host"
    assert encode.last_timings["upload_bytes"] == 0
    assert bytes(got) == codec.compress_payload_numpy(raw, nb, 1, br, chunk,
                                                      check_th_after_percent=10,
                                                      shared_tables=shared)
    back = codec.decompress_payload(bytes(got), nb, 1, br, chunk, raw.size, engine="cuda",
                                    device=card)
    assert np.array_equal(back.cpu().numpy(), raw)


MESH_CASES = [(torch.bfloat16, "per_chunk"), (torch.bfloat16, "shared"),
              (torch.float32, "per_chunk"), (torch.float32, "shared")]


@pytest.mark.parametrize("dtype,profile", MESH_CASES)
def test_two_shard_mesh_on_one_card_equals_no_mesh(card, dtype, profile):
    """A mesh of two entries on one card: each encode kernel (K8 + K7, or
    H + E, and ``splice_cells``) and each decode kernel (K1 or K6, and K2)
    launches once a shard of each batch, and the container and the decode
    onto the card equal those of no mesh."""
    from zipnn_tpu_torch import parallel

    raw = _raw(dtype, (64 << 20) + 1002, 81)
    x = torch.from_numpy(raw).view(dtype).to(card)
    runs = []
    for mesh in (None, parallel.make_mesh([card, card])):
        with parallel.use_mesh(mesh):
            kernels.reset_launches()
            comp = bytes(ZipNN(input_format="torch", huffman_table=profile).compress(x))
            enc = dict(kernels.launches)
            kernels.reset_launches()
            y = ZipNN(input_format="torch").decompress(comp)
            dec = dict(kernels.launches)
        assert y.is_cuda and torch.equal(y.view(torch.uint8), x.view(torch.uint8))
        runs.append((comp, enc, dec))
    (c0, e0, d0), (c2, e2, d2) = runs
    assert c2 == c0
    enc_names = (("const_scan_rows", "huf_shared_encode") if profile == "shared"
                 else ("hist_cells", "huf_pc_encode")) + ("splice_cells",)
    for k in enc_names:
        assert e0[k] > 0 and e2[k] == 2 * e0[k], (k, e0[k], e2[k])
    dec_name = "huf_shared_decode" if profile == "shared" else "huf_pc_decode"
    assert d0[dec_name] == 1 and d2[dec_name] == 2  # one batch of 256 chunks and a tail
    assert d0["combine_cells"] == 1 and d2["combine_cells"] == 2


WORKER_CUDA = r"""
import sys
from zipnn_tpu_torch.parallel import multihost

port, rank, src, out, back = sys.argv[1], int(sys.argv[2]), *sys.argv[3:6]
multihost.initialize(f"127.0.0.1:{port}", 2, rank)
for profile in ("per_chunk", "shared"):
    multihost.compress_file_multihost(src, out + profile, huffman_table=profile)
    multihost.decompress_file_multihost(out + profile, back + profile)
"""


def test_two_ranks_on_the_card(card, tmp_path):
    """Two processes on the one card (engine cuda, gloo): each file equals
    one process's ``ZipNN`` container on the card, and decompresses back
    on the card exactly."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    data = _raw(torch.bfloat16, (24 << 20) + 777, 82).tobytes()
    src = tmp_path / "w.bin"
    src.write_bytes(data)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER_CUDA, str(port), str(rank), str(src),
                               str(tmp_path / "o."), str(tmp_path / "b.")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for rank in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-3000:]
    for profile in ("per_chunk", "shared"):
        want = bytes(ZipNN(huffman_table=profile).compress(data))
        assert (tmp_path / f"o.{profile}").read_bytes() == want
        assert (tmp_path / f"b.{profile}").read_bytes() == data
