"""PyTorch port: the shared-table compress of ``engine="cuda"``
(``ops/encode.py``; the per-chunk profile is in ``test_torch_pc_encode.py``),
run here through the kernels' plain versions (``device="cpu"``), held
against the JAX package with tolerance 0:

* ``transforms.split_device`` equals ``jax_transforms.split_device`` and
  the golden ``byte_group.split``;
* every container equals ``zipnn_tpu``'s golden shared-table encoder byte
  for byte: four dtypes at sampling stride 1 and 8, ragged tails on and
  off the stride, an uncodeable cell, an RLE cell on a hopeless plane, an
  all-constant input, inputs shorter than a chunk, and several batches;
* chunks whose planes are under one word take the device encoder's
  sub-word route, both profiles;
* a container decodes back through the port's own ``engine="cuda"``
  decode;
* ``encode.finish(encode.start(...))`` equals the golden encoder in both
  profiles, bf16 and fp32, over several batches, with no full chunk and at
  sub-word chunks, and ``start`` calls its ``between`` hook once, after
  the first launch and before the first fetch;
* ``splice.splice_cells``' plain version writes the native core's splice
  of the same cells: a batch of raw, RLE, Huffman and uncodeable cells,
  and random cells at unaligned offsets, 1-byte ones among them; cells
  that read or write outside their sources raise.

The CUDA kernels run in ``test_torch_cuda.py``.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import zipnn_tpu
from zipnn_tpu import codec as ref_codec
from zipnn_tpu.ops import byte_group, jax_transforms
from zipnn_tpu_torch import ZipNN, codec, native
from zipnn_tpu_torch.ops import encode, splice, transforms

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 1024  # small chunks: >= 512 of them (stride 8) stay cheap
DTYPES = [torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float32]


def _tensor(dtype, nbytes: int, seed: int) -> torch.Tensor:
    """N(0, 0.05) values of ``dtype`` filling ``nbytes`` bytes."""
    rng = np.random.default_rng(seed)
    size = nbytes // torch.empty(0, dtype=dtype).element_size()
    return torch.from_numpy((rng.standard_normal(size) * 0.05).astype(np.float32)).to(dtype)


def _golden(x: torch.Tensor, chunk=CHUNK) -> bytes:
    return bytes(zipnn_tpu.ZipNN(input_format="torch", engine="numpy", huffman_table="shared",
                                 compression_chunk=chunk).compress(x))


def _port(x, chunk=CHUNK, **kw) -> bytes:
    kw.setdefault("huffman_table", "shared")
    return bytes(ZipNN(input_format="torch", engine="cuda", device="cpu",
                       compression_chunk=chunk, **kw).compress(x))


@pytest.mark.parametrize("num_buf,byte_reorder,bit_reorder", [
    (1, 10, 0), (1, 10, 1), (2, 10, 0), (2, 10, 1), (4, 220, 0), (4, 220, 1),
])
def test_split_device_matches_jax_and_golden(num_buf, byte_reorder, bit_reorder):
    rng = np.random.default_rng(num_buf * 10 + bit_reorder)
    w = rng.integers(0, 1 << 32, (3, 128), dtype=np.uint64).astype(np.uint32)
    w[0, :4] = [0, 0xFFFFFFFF, 0x80008000, 0x7F807F80]
    got = transforms.split_device(torch.from_numpy(w.view(np.int32)), num_buf,
                                  byte_reorder, bit_reorder).numpy().view(np.uint32)
    want = np.asarray(jax_transforms.split_device(jnp.asarray(w), num_buf, byte_reorder,
                                                  bit_reorder))
    np.testing.assert_array_equal(got, want)
    for c in range(3):
        planes = byte_group.split(w[c].view(np.uint8), num_buf, byte_reorder, bit_reorder)
        for b in range(num_buf):
            assert got[c, b].view(np.uint8).tobytes() == planes[b].tobytes()


def test_split_device_rejects_other_modes():
    w = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        transforms.split_device(w, 2, 220, 0)
    with pytest.raises(ValueError):
        transforms.split_device(w, 3, 10, 0)


@pytest.mark.parametrize("n_chunks", [24, 520], ids=["stride1", "stride8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_shared_encode_byte_identical(dtype, n_chunks):
    x = _tensor(dtype, n_chunks * CHUNK, seed=n_chunks)
    got = _port(x)
    assert encode.last_timings["encoder"] == "huf_shared_encode"
    assert got == _golden(x)


def _mk(n_chunks, seed=3):
    """bf16-shaped planes (mode 10, no sign rotation): plane 1 a
    compressible 'exponent' N(128, 3), plane 0 a random (hopeless at
    stride 8) 'mantissa'."""
    rng = np.random.default_rng(seed)
    half = CHUNK // 2
    exp = np.clip(rng.normal(128, 3, (n_chunks, half)), 0, 255).astype(np.uint8)
    man = rng.integers(0, 256, (n_chunks, half), dtype=np.uint8)
    return exp, man


def _join(exp, man):
    out = np.empty(exp.shape + (2,), np.uint8)
    out[..., 0], out[..., 1] = man, exp
    return out.reshape(-1)


def _codec_pair(data):
    got = codec.compress_payload(data, 2, 0, 10, CHUNK, engine="cuda", shared_tables=True,
                                 device="cpu")
    want = ref_codec.compress_payload_numpy(data, 2, 0, 10, CHUNK, shared_tables=True)
    return bytes(got), bytes(want)


@pytest.mark.parametrize("n_chunks,extra", [
    (24, 317),   # stride 1, the tail in the table
    (519, 700),  # stride 8, tail index 519 off the stride
    (520, 96),   # stride 8, tail index 520 on the stride (sampled)
])
def test_ragged_tail_byte_identical(n_chunks, extra):
    exp, man = _mk(n_chunks + 1)
    data = _join(exp, man)[: n_chunks * CHUNK + extra]
    got, want = _codec_pair(data)
    assert got == want


def test_uncodeable_cell_and_rle_on_hopeless_plane():
    exp, man = _mk(520)
    exp[9, 7] = 251  # chunk 9 is not sampled: the table has no code for 251
    man[13] = 0x42   # a constant cell on the hopeless mantissa plane
    data = _join(exp, man)
    got, want = _codec_pair(data)
    assert got == want
    types, starts, _ = ref_codec.parse_tables(got, 2, 520)
    sizes = np.diff(starts, axis=1)
    assert types[1, 9] == 0 and sizes[1, 9] == CHUNK // 2  # stored raw
    assert types[1, 8] == 1 and types[1, 10] == 1
    assert types[0, 13] == 1 and sizes[0, 13] == 1          # RLE
    assert not types[0, :13].any()                          # hopeless plane


@pytest.mark.parametrize("nbytes", [0, 2, 700, CHUNK - 2, CHUNK + 2])
def test_short_inputs_byte_identical(nbytes):
    x = _tensor(torch.bfloat16, nbytes, seed=nbytes)
    assert _port(x) == _golden(x)


@pytest.mark.parametrize("n_chunks", [30, 530])
def test_all_constant_input(n_chunks):
    x = torch.full((n_chunks * CHUNK // 2 + 3,), 0.5, dtype=torch.bfloat16)
    got = _port(x)
    assert got == _golden(x)
    after = ZipNN(engine="cuda", device="cpu")._retrieve_header(memoryview(got))
    types, starts, _ = ref_codec.parse_tables(got[after:], 2, n_chunks + 1)
    # every full chunk's cells RLE (the tail's last lane stays unrotated)
    assert types[:, :-1].all() and (np.diff(starts, axis=1)[:, :-1] == 1).all()


@pytest.mark.parametrize("n_chunks,extra,per_batch", [
    (540, 700, lambda s: 3 * s),  # stride 8: batches of 24 chunks
    (30, 500, lambda s: 7),       # stride 1: batches of 7, uploaded one by one
])
def test_multi_batch_matches_single_batch(monkeypatch, n_chunks, extra, per_batch):
    exp, man = _mk(n_chunks + 1, seed=5)
    exp[17, 3] = 250  # an uncodeable cell inside a later batch
    data = _join(exp, man)[: n_chunks * CHUNK + extra]
    one, want = _codec_pair(data)
    monkeypatch.setattr(encode, "batch_chunks", lambda cs, stride: per_batch(stride))
    many, _ = _codec_pair(data)
    assert encode.last_timings["batches"] > 3
    assert many == one == want


@pytest.mark.parametrize("case", ["batches", "no_full_chunk", "sub_word"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_chunk"])
def test_start_finish_match_golden_and_call_between_once(monkeypatch, shared, dtype, case):
    """``finish(start(...))`` against the JAX package's golden encoder; the
    order of the first launch (the split), the ``between`` call and the
    first fetch."""
    nb = 2 if dtype == torch.bfloat16 else 4
    br = 10 if nb == 2 else 220
    chunk, nbytes = {"batches": (1024, 10 * 1024 + 300), "no_full_chunk": (1024, 700),
                     "sub_word": (2 * nb, 40 * 2 * nb + 3)}[case]
    data = _tensor(dtype, nbytes, seed=nb).view(torch.uint8).numpy()
    monkeypatch.setattr(encode, "BATCH_BYTES", 3 * chunk)
    order = []
    for mod, name in ((transforms, "split_device"), (transforms, "split_bytes"),
                      (encode.Source, "get")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _tag="get" if name == "get" else "launch", **kw):
            order.append(_tag)
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    run = encode.start(data, nb, 1, br, chunk, check_th_after_percent=10, shared_tables=shared,
                       device="cpu", prefix_len=5, between=lambda: order.append("between"))
    got = encode.finish(run)
    want = ref_codec.compress_payload_numpy(data, nb, 1, br, chunk, check_th_after_percent=10,
                                            shared_tables=shared)
    assert bytes(got[5:]) == want
    assert order.count("between") == 1
    at = order.index("between")
    assert "get" not in order[:at]
    assert ("launch" in order[:at]) == (case != "no_full_chunk")
    assert encode.last_timings["batches"] == {"batches": 4, "no_full_chunk": 0,
                                              "sub_word": 1}[case]


def _cells_against_native(out, cells, groups, hpool, card_splice=splice.splice_cells):
    card_splice(out, cells, groups, hpool)
    again = np.zeros(out.numel(), np.uint8)
    native.splice_cells(again, **splice.host_cells(cells, groups, hpool))
    assert np.array_equal(out.numpy(), again)
    return np.bincount((cells[:, splice.INFO] >> 32) & 0xFF, minlength=3)


def test_splice_cells_plain_matches_native_on_a_mixed_batch(monkeypatch):
    """The uncodeable-cell input: its batch holds raw, RLE and Huffman cells
    and a cell that K7 could not code (stored raw)."""
    exp, man = _mk(520)
    exp[9, 7] = 251
    man[13] = 0x42
    kinds = []
    monkeypatch.setattr(splice, "splice_cells",
                        lambda *a, _fn=splice.splice_cells: kinds.append(
                            _cells_against_native(*a, card_splice=_fn)))
    got, want = _codec_pair(_join(exp, man))
    assert got == want
    assert len(kinds) == 1 and kinds[0].all()


def test_splice_cells_plain_matches_native_at_unaligned_offsets():
    rng = np.random.default_rng(5)
    planes = torch.from_numpy(rng.integers(0, 256, (12, 40), dtype=np.uint8)).view(torch.int32)
    rows = torch.from_numpy(rng.integers(0, 256, (16, 36), dtype=np.uint8)).view(torch.int32)
    hpool = torch.from_numpy(rng.integers(0, 256, 48, dtype=np.uint8))
    kind = np.array([0, 1, 2, 0, 2, 1, 0, 2, 0, 0, 1, 2])
    size = np.array([40, 1, 0, 17, 0, 1, 1, 0, 39, 5, 1, 0])
    sb = np.zeros((12, 4), np.int64)
    huf = kind == 2
    sb[huf] = rng.integers(1, 37, (huf.sum(), 4))
    sb[7] = [1, 1, 1, 36]
    hlen = np.where(huf, rng.integers(1, 9, 12), 0)
    size[huf] = hlen[huf] + 6 + sb[huf].sum(axis=1)
    cells = np.zeros((12, splice.FIELDS), np.int64)
    cells[:, splice.DST] = 3 + np.cumsum(size) - size
    cells[:, splice.INFO] = splice.info(size, kind, huf.astype(int), hlen)
    cells[:, splice.SRC] = splice.src(np.where(huf, 4 * np.arange(12) % 13, np.arange(12)),
                                      np.where(huf, rng.integers(0, 40, 12), 0))
    cells[:, splice.SB] = splice.pack_sb(sb)
    out = torch.zeros(int(size.sum()) + 9, dtype=torch.uint8)
    assert _cells_against_native(out, cells, [planes, rows], hpool).all()
    for field, value in ((splice.DST, out.numel()), (splice.SRC, 13), (splice.SB, 0),
                         (splice.INFO, splice.info(41, 0))):
        bad = cells.copy()
        bad[0 if field == splice.INFO else 2, field] = value
        with pytest.raises(ValueError, match="outside"):
            splice.splice_cells(out, bad, [planes, rows], hpool)


def test_roundtrip_through_port_decode():
    x = _tensor(torch.bfloat16, 520 * CHUNK + 1234, seed=11)
    comp = _port(x)
    y = ZipNN(input_format="torch", engine="cuda", device="cpu").decompress(comp)
    assert torch.equal(y.view(torch.int16), x.view(torch.int16))


def test_byte_input_and_fp32_tail():
    x = _tensor(torch.float32, 513 * CHUNK + 12, seed=4)
    raw = x.numpy().tobytes()
    got = bytes(ZipNN(engine="cuda", device="cpu", huffman_table="shared",
                      bytearray_dtype="float32", compression_chunk=CHUNK).compress(raw))
    want = bytes(zipnn_tpu.ZipNN(engine="numpy", huffman_table="shared",
                                 bytearray_dtype="float32", compression_chunk=CHUNK).compress(raw))
    assert got == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_small_chunks_encode_on_device(dtype, chunk):
    """Chunks below 512 bytes take the device encoder too (planes of 4
    bytes and more; K7 runs on planes of 16 and more), byte-identical."""
    x = _tensor(dtype, 41 * chunk + 5, seed=chunk)
    got = _port(x, chunk=chunk)
    assert encode.last_timings["encoder"] == "huf_shared_encode"
    assert got == _golden(x, chunk=chunk)


def test_planes_neither_words_nor_short_raise():
    """Planes that are not whole words and could be Huffman (12 bytes or
    more: chunk sizes that are not a power of 2) are refused."""
    with pytest.raises(ValueError, match="whole 4-byte words or planes under 12"):
        encode.compress_payload(np.zeros(4096, np.uint8), 2, 1, 10, 100, device="cpu")


# every chunk size whose planes are under one 4-byte word
SUB_WORD = [(dt, cs) for dt, top in ((torch.bfloat16, 4), (torch.float16, 4),
                                     (torch.float32, 8), (torch.float8_e4m3fn, 2))
            for cs in (1, 2, 4, 8) if cs <= top]


@pytest.mark.parametrize("dtype,chunk", SUB_WORD,
                         ids=[f"{str(d).split('.')[-1]}-{c}" for d, c in SUB_WORD])
def test_planes_below_a_word_on_device(dtype, chunk):
    """``engine="cuda"`` encodes there by the device encoder's sub-word
    route, both profiles (the per-chunk one with its threshold check,
    ``check_th_after_percent`` 10, abandoning planes), equal to the JAX
    package's numpy engine; the port decodes it back."""
    x = _tensor(dtype, 301 * 4, seed=chunk)
    x.view(torch.uint8)[40:200] = 7  # RLE cells
    for profile in ("shared", "per_chunk"):
        got = _port(x, chunk=chunk, huffman_table=profile)
        assert encode.last_timings["encoder"] == "sub_word"
        assert got == bytes(zipnn_tpu.ZipNN(
            input_format="torch", engine="numpy", huffman_table=profile,
            compression_chunk=chunk).compress(x)), profile
        y = ZipNN(input_format="torch", engine="cuda", device="cpu").decompress(got)
        assert torch.equal(y.view(torch.uint8), x.view(torch.uint8))


@pytest.mark.parametrize("threshold", [0.5, 0.95, 1.5])
def test_sub_word_route_thresholds(threshold):
    """The sub-word route's decisions at every plane layout: a 2-byte RLE
    cell stores raw at threshold 0.5, a 1-byte one RLE at 1.5, and the
    per-chunk threshold check abandons planes (``check_th_after_percent``
    0, 10, 50), equal to the golden encoder."""
    rng = np.random.default_rng(int(threshold * 10))
    data = rng.integers(0, 3, 3001, dtype=np.uint8)
    data[500:900] = 5
    for nb, bo, br, chunk in ((2, 1, 10, 4), (2, 1, 10, 2), (2, 0, 10, 1), (4, 1, 220, 8),
                              (4, 1, 220, 4), (4, 0, 220, 2), (1, 0, 10, 2), (1, 0, 10, 1)):
        for pct in (0, 10, 50):
            for shared in (False, True):
                got = codec.compress_payload(data, nb, bo, br, chunk, threshold, engine="cuda",
                                             device="cpu", check_th_after_percent=pct,
                                             shared_tables=shared)
                assert encode.last_timings["encoder"] == "sub_word"
                assert bytes(got) == ref_codec.compress_payload_numpy(
                    data, nb, bo, br, chunk, threshold, check_th_after_percent=pct,
                    shared_tables=shared), (nb, chunk, pct, shared)


def test_golden_routes_named(monkeypatch):
    """No geometry reaches the golden encoder on ``engine="cuda"``: planes
    under one word take the device encoder's sub-word route in either
    profile, whole-word planes its kernels."""
    def refuse(*a, **kw):
        raise AssertionError("engine='cuda' reached the golden encoder")

    monkeypatch.setattr(codec, "compress_payload_numpy", refuse)
    x = _tensor(torch.bfloat16, 40 * 4 + 2, seed=2)
    for chunk, route in ((4, "sub_word"), (8, None)):
        for profile in ("per_chunk", "shared"):
            got = bytes(ZipNN(input_format="torch", engine="cuda", device="cpu",
                              huffman_table=profile, compression_chunk=chunk).compress(x))
            want = bytes(zipnn_tpu.ZipNN(input_format="torch", engine="numpy",
                                         huffman_table=profile,
                                         compression_chunk=chunk).compress(x))
            assert got == want
            assert encode.last_timings["encoder"] == route or (
                route is None and encode.last_timings["encoder"] != "sub_word")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode.compress_payload(np.zeros(4096, np.uint8), 2, 1, 10, 1024, device="cuda")


def test_encode_modules_import_neither_jax_nor_reference():
    for name in ("ops/encode", "ops/huf_enc", "ops/const_scan", "ops/hist",
                 "ops/transforms", "ops/splice", "ops/staging", "io/serving", "native"):
        tree = ast.parse((ROOT / "zipnn_tpu_torch" / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & {"jax", "jaxlib", "zipnn_tpu"}, (name, tops)
