"""PyTorch port: the native host core (``zipnn_tpu_torch/native.py``, the
port's copy of ``csrc/ztpu_core.cpp``) against the plain Python versions
it replaces on the card's paths and against the JAX package, tolerance 0:

* the library builds into ``_build/`` under its content name, a second
  load does not rebuild it, and a failed build raises;
* ``native.build_ctables`` equals ``encode.cell_table`` (status, header
  bytes, packed K7 entries) on the cells of seeded bf16 and fp32 buffers
  and on edge histograms;
* the native decode-table parse (``huf_pc.distinct_tables``) equals the Python
  one (``distinct_tables_plain``) on the headers of ``tests/fixtures/*.znn``
  and of a per-chunk bf16 container, and names the same first bad cell of
  a corrupt header;
* the native splice equals the card's (``splice.splice_cells``, here its
  plain version) on every batch of multi-batch encodes with an abandoned
  plane and a ragged tail, both profiles;
* engine ``"native"`` writes the containers of ``zipnn_tpu.native`` and of
  the golden encoder for four dtypes, both profiles,
  ``check_th_after_percent`` 0 and 10, and decodes them.

The native build (a few seconds) happens once per run: concurrent
processes wait on its file lock.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import zipnn_tpu
from zipnn_tpu import codec as ref_codec
from zipnn_tpu import native as ref_native
from zipnn_tpu_torch import CorruptChunkError, ZipNN, codec, native
from zipnn_tpu_torch.core import dtypes
from zipnn_tpu_torch.ops import decode, encode, huf_enc, huf_pc, splice

ROOT = Path(__file__).resolve().parent.parent
FIXDIR = ROOT / "tests" / "fixtures"
DTYPES = [torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float32]


def _tensor(dtype, nbytes: int, seed: int) -> torch.Tensor:
    """N(0, 0.05) values of ``dtype`` filling ``nbytes`` bytes."""
    rng = np.random.default_rng(seed)
    size = nbytes // torch.empty(0, dtype=dtype).element_size()
    return torch.from_numpy((rng.standard_normal(size) * 0.05).astype(np.float32)).to(dtype)


def test_build_named_by_content_and_loaded_once():
    so = native.build()
    assert so.parent == ROOT / "zipnn_tpu_torch" / "_build"
    assert so.name == f"libztpu_core_{native.source_tag()}.so" and so.exists()
    native.lib()
    mtime = so.stat().st_mtime_ns
    code = ("import zipnn_tpu_torch.native as n; n.lib(); "
            "print(n.build_seconds, n.build().name)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert res.stdout.split() == ["None", so.name]  # loaded, not rebuilt
    assert so.stat().st_mtime_ns == mtime


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "ztpu_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def _weight_cells(dtype, seed):
    """(counts [m, 256], n): every plane cell of 16 chunks of 8 KB."""
    x = _tensor(dtype, 16 * 8192, seed).view(torch.uint8).numpy()
    gr = dtypes.grouping_for_code(dtypes.from_any(dtype).code)
    rows = x.reshape(16, 8192)
    nb = gr.num_buf
    counts = [np.bincount(r[b::nb], minlength=256) for r in rows for b in range(nb)]
    return np.stack(counts), 8192 // nb


def _edge_cells():
    """(name, counts [256], n) histograms at the edges of the table build."""
    two = np.zeros(256, np.int64)
    two[[3, 200]] = [700, 300]
    top = np.zeros(256, np.int64)
    top[[0, 17, 255]] = [500, 300, 200]
    fib = np.zeros(256, np.int64)  # heap Huffman past 11 bits: package-merge
    a, b = 1, 1
    for s in range(20):
        fib[s * 7] = a
        a, b = b, a + b
    wide = np.zeros(256, np.int64)  # 20 symbols up to 250 in 24 bytes: header too long
    wide[0] = 5
    wide[np.linspace(10, 250, 19).astype(int)] = 1
    one = np.zeros(256, np.int64)  # one symbol: no code lengths
    one[42] = 100
    return [("two", two, 1000), ("max_sv_255", top, 1000),
            ("fibonacci", fib, int(fib.sum())), ("header_too_long", wide, 24),
            ("no_lengths", one, 100)]


def _hold_ctables(counts, n):
    status, lengths, vals, headers, hlens = native.build_ctables(counts, n)
    for i, count in enumerate(counts):
        want = encode.cell_table(count, n)
        assert status[i] == (want is not None), i
        if want is None:
            assert hlens[i] == 0 and not lengths[i].any()
            continue
        assert bytes(headers[i, : hlens[i]]) == want[0], i
        assert np.array_equal(huf_enc.pack_pc_table(vals[i], lengths[i]), want[1]), i
    return status


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_build_ctables_matches_cell_table_on_weights(dtype):
    counts, n = _weight_cells(dtype, seed=3)
    status = _hold_ctables(counts, n)
    assert status.sum() >= counts.shape[0] // 2  # the exponent planes are Huffman


@pytest.mark.parametrize("case", _edge_cells(), ids=lambda c: c[0])
def test_build_ctables_matches_cell_table_on_edges(case):
    _, count, n = case
    status = _hold_ctables(count[None, :], n)
    if case[0] in ("header_too_long", "no_lengths"):
        assert status[0] == 0
    else:
        assert status[0] == 1
    if case[0] == "fibonacci":
        heap = native.build_ctables(count[None, :], 1 << 20)[1][0]
        assert heap.max() == 11  # limited to the tableLog the cell size gives


def _headers_of(container: bytes):
    """The weight headers a decode plan parses, in cell order."""
    seen = []
    plain = huf_pc.distinct_tables

    def spy(headers):
        seen.append(list(headers))
        return plain(headers)

    z = ZipNN(engine="cuda", device="cpu")
    after = z._retrieve_header(memoryview(container))
    geo = (dtypes.groups_for_decompress(z.dtype), z._bit_reorder, z._byte_reorder,
           z.compression_chunk, z.original_len)
    decode.huf_pc.distinct_tables = spy
    try:
        decode.build_plan(memoryview(container)[after:], *geo)
    finally:
        decode.huf_pc.distinct_tables = plain
    return seen[0]


_CONTAINERS = [f"{f}.znn" for f in ("bf16_gauss", "fp16_mixed", "fp8_gauss", "fp32_gauss")] \
    + ["bf16_per_chunk"]


def _container(name):
    if name.endswith(".znn"):
        return (FIXDIR / name).read_bytes()
    return bytes(zipnn_tpu.ZipNN(input_format="torch", engine="numpy", compression_chunk=4096)
                 .compress(_tensor(torch.bfloat16, 40 * 4096 + 6, seed=5)))


@pytest.mark.parametrize("name", _CONTAINERS)
def test_cell_tables_match_plain(name):
    headers = _headers_of(_container(name))
    assert len(headers) > 0
    got = huf_pc.distinct_tables(headers)
    want = huf_pc.distinct_tables_plain(headers)
    assert got[3] == want[3]
    assert all(np.array_equal(a, b) for a, b in zip(got[:3], want[:3]))
    bad = list(headers)
    at = min(3, len(bad) - 1)
    bad[at] = b"\x81\xff"  # two weights of 15: past the 12-bit limit
    bad[-1] = b"\x05\x01"  # truncated FSE weights
    errs = []
    for parse in (huf_pc.distinct_tables, huf_pc.distinct_tables_plain):
        with pytest.raises(ValueError) as exc:
            parse(bad)
        errs.append(exc.value.index)
    assert errs == [at, at]


def test_corrupt_header_names_cell_in_decode():
    comp = bytearray(_container("bf16_per_chunk"))
    z = ZipNN(engine="cuda", device="cpu")
    after = z._retrieve_header(memoryview(bytes(comp)))
    types, starts, data_start = codec.parse_tables(memoryview(bytes(comp))[after:], 2, 41)
    b, c = 1, 7  # an exponent cell, Huffman
    assert types[b, c] == 1
    base = after + data_start + starts[0, -1] + starts[b, c]
    comp[base : base + 2] = b"\x81\xff"
    with pytest.raises(CorruptChunkError) as exc:
        z.decompress(bytes(comp))
    assert (exc.value.plane, exc.value.chunk) == (b, c)


def _spliced(monkeypatch, run):
    """Every batch that ``run()``'s encode writes through
    ``splice.splice_cells`` is written again by the native core's splice
    from the same cells: the bytes must agree.  Returns the number of
    batches."""
    got = []
    card_splice = splice.splice_cells

    def both(out, cells, groups, hpool):
        card_splice(out, cells, groups, hpool)
        again = np.zeros(out.numel(), np.uint8)
        native.splice_cells(again, **splice.host_cells(cells, groups, hpool))
        assert np.array_equal(out.numpy(), again)
        kinds = (cells[:, splice.INFO] >> 32) & 0xFF
        got.append(np.bincount(kinds, minlength=3))

    monkeypatch.setattr(splice, "splice_cells", both)
    run()
    return got


@pytest.mark.parametrize("shared", [False, True], ids=["per_chunk", "shared"])
def test_splice_matches_plain(monkeypatch, shared):
    """Batches of 3 chunks of 1 KB: the per-chunk check after chunk 5
    abandons plane 0 (random up to it, with an RLE cell after it); the
    shared profile has RLE, raw and Huffman cells; a ragged tail."""
    chunk = 1024
    monkeypatch.setattr(encode, "batch_chunks", lambda cs, stride: 3)
    rng = np.random.default_rng(11)
    hi = np.clip(rng.normal(128, 3, (41, chunk // 2)), 0, 255).astype(np.uint8)
    lo = rng.integers(0, 256, (41, chunk // 2), dtype=np.uint8)
    lo[6:] = hi[6:] ^ 0x55
    lo[9] = 0x42
    hi[12] = 0x17
    data = np.stack([lo, hi], axis=-1).reshape(-1)[: 40 * chunk + 300]

    def run():
        got = codec.compress_payload(data, 2, 0, 10, chunk, engine="cuda", device="cpu",
                                     check_th_after_percent=10, shared_tables=shared,
                                     prefix_len=7)
        want = ref_codec.compress_payload_numpy(data, 2, 0, 10, chunk,
                                                check_th_after_percent=10,
                                                shared_tables=shared)
        assert bytes(got[7:]) == want

    kinds = _spliced(monkeypatch, run)
    assert len(kinds) == 14 and np.sum(kinds, axis=0).all()  # raw, RLE and Huffman cells


_GOOD_CELL = dict(kind=2, hid=0, hoff=0, hlen=3, boff=0, size=3 + 6 + 4)


@pytest.mark.parametrize("bad", [
    {}, dict(hoff=2), dict(hoff=-1), dict(hlen=5), dict(hid=1), dict(hid=-1),
    dict(boff=1), dict(size=3 + 6 + 5), dict(kind=0, size=5), dict(kind=0, size=2, boff=-1),
], ids=["valid", "header_past_pool", "header_before_pool", "header_longer_than_pool",
        "header_id_past", "header_id_negative", "stream_past_blob", "cell_past_blob",
        "raw_past_blob", "raw_before_blob"])
def test_splice_cells_rejects_reads_outside(bad):
    """One cell after a valid RLE cell: a Huffman cell (a 3-byte header
    from a 4-byte pool, the jump table, 4 stream bytes) or a raw cell that
    reads outside the header pool or the blob fails as cell 1 and writes
    nothing there."""
    cell = {**_GOOD_CELL, **bad}
    out = np.zeros(32, np.uint8)
    hpool, blob = np.arange(1, 5, dtype=np.uint8), np.arange(10, 14, dtype=np.uint8)
    args = ([0, 1], [1, cell["kind"]], [1, cell["size"]], [0x42, 0], [0, cell["hid"]],
            hpool, [cell["hoff"]], [cell["hlen"]], np.zeros((2, 3), np.uint16),
            [0, cell["boff"]], blob)
    if not bad:
        native.splice_cells(out, *args)
        assert bytes(out[:14]) == b"\x42\x01\x02\x03" + bytes(6) + bytes(range(10, 14))
        return
    with pytest.raises(ValueError, match="cell 1 reads outside"):
        native.splice_cells(out, *args)
    assert out[0] == 0x42 and not out[1:].any()


@pytest.mark.parametrize("pct", [0, 10])
@pytest.mark.parametrize("shared", [False, True], ids=["per_chunk", "shared"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_engine_native_matches_reference(dtype, shared, pct):
    chunk = 1024
    x = _tensor(dtype, 40 * chunk + 6, seed=pct + 2)
    x.view(torch.uint8)[3 * chunk : 4 * chunk] = 0x3C  # RLE cells
    profile = "shared" if shared else "per_chunk"
    kw = dict(input_format="torch", compression_chunk=chunk, huffman_table=profile,
              check_th_after_percent=pct)
    got = ZipNN(engine="native", **kw).compress(x)
    assert type(got) is bytes
    assert got == bytes(zipnn_tpu.ZipNN(engine="numpy", **kw).compress(x))
    gr = dtypes.grouping_for_code(dtypes.from_any(dtype).code)
    arr = x.view(torch.uint8).numpy()
    args = (arr, gr.num_buf, gr.bit_reorder, gr.byte_reorder,
            codec.effective_chunk(chunk, gr.num_buf), codec.DEFAULT_THRESHOLD)
    mine = codec.compress_payload(*args[:6], engine="native", shared_tables=shared,
                                  check_th_after_percent=pct)
    if shared:
        ref = ref_native.compress_payload_shared(*args, threads=0)
    else:
        ref = ref_native.compress_payload(*args, threads=0, check_th_after_percent=pct)
    assert type(mine) is bytes and mine == bytes(ref)
    y = ZipNN(input_format="torch", engine="native").decompress(got)
    assert torch.equal(y.view(torch.uint8), x.view(torch.uint8))


def test_engine_native_sampled_shared_and_corrupt():
    """520 chunks (the sampled stride-8 shared table), both directions; a
    flipped bit in a Huffman stream raises the golden decoder's
    CorruptChunkError."""
    x = _tensor(torch.bfloat16, 520 * 256 + 10, seed=8)
    kw = dict(input_format="torch", compression_chunk=256, huffman_table="shared")
    got = bytes(ZipNN(engine="native", **kw).compress(x))
    assert got == bytes(zipnn_tpu.ZipNN(engine="numpy", **kw).compress(x))
    y = ZipNN(input_format="torch", engine="native").decompress(got)
    assert torch.equal(y.view(torch.int16), x.view(torch.int16))
    z = ZipNN(engine="native")
    after = z._retrieve_header(memoryview(got))
    types, starts, data_start = codec.parse_tables(memoryview(got)[after:], 2, 521)
    c = int(np.nonzero(types[1])[0][3])
    at = after + data_start + starts[0, -1] + starts[1, c + 1] - 2
    bad = bytearray(got)
    bad[at] ^= 0x10
    with pytest.raises(CorruptChunkError):
        z.decompress(bytes(bad))
