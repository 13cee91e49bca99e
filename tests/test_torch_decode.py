"""PyTorch port, the whole slice: ``zipnn_tpu_torch.ZipNN`` against
``zipnn_tpu``.

* decode: the port (``engine="cuda"``, ``device="cpu"``, so the kernels'
  plain versions run) against ``zipnn_tpu.ZipNN(engine="tpu")`` and
  ``engine="numpy"`` and the committed libzstd-made fixtures, bit-exact,
  for bf16, fp16, fp8 and fp32 in both Huffman profiles;
* encode: the port's golden encoder writes the same container bytes as
  ``zipnn_tpu``'s ``engine="numpy"``, per-chunk and shared-table (with
  and without the sampled table);
* errors: a flipped stream bit raises at the same (plane, chunk, stream)
  as ``zipnn_tpu`` on both decode kernels; a missing GPU raises instead
  of taking a host path;
* isolation: the port imports neither ``jax`` nor ``zipnn_tpu``.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import zipnn_tpu
import zipnn_tpu_torch
from zipnn_tpu.errors import CorruptChunkError as RefCorrupt
from zipnn_tpu_torch import CorruptChunkError, ZipNN
from zipnn_tpu_torch.core import dtypes
from zipnn_tpu_torch.ops import decode

ROOT = Path(__file__).resolve().parent.parent
FIXDIR = ROOT / "tests" / "fixtures"
CHUNK = 16384


def _raw(dtype: str, nbytes: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(nbytes // 2 + 1) * 0.05).astype(np.float32)
    if dtype == "bfloat16":
        b = (vals.view(np.uint32) >> 16).astype(np.uint16).tobytes()
    elif dtype == "float16":
        b = vals.astype(np.float16).tobytes()
    elif dtype == "float32":
        b = vals.tobytes()
    else:  # fp8: byte-level stand-in with the e4m3 shape of a gaussian
        b = np.clip(rng.normal(56, 6, nbytes), 0, 255).astype(np.uint8).tobytes()
    return b[:nbytes]


def _ref_container(raw: bytes, dtype: str, **kw) -> bytes:
    kw.setdefault("compression_chunk", CHUNK)
    return bytes(zipnn_tpu.ZipNN(engine="numpy", bytearray_dtype=dtype, **kw).compress(raw))


def _port(**kw):
    kw.setdefault("device", "cpu")
    return ZipNN(**kw)


@pytest.mark.parametrize("dtype,nbytes", [
    ("bfloat16", 5 * CHUNK + 6002), ("float16", 4 * CHUNK + 1234),
    ("float8_e4m3fn", 5 * CHUNK + 777),
])
def test_decode_matches_tpu_and_numpy_engines(dtype, nbytes):
    raw = _raw(dtype, nbytes, seed=nbytes)
    comp = _ref_container(raw, dtype)
    got = bytes(_port(engine="cuda").decompress(comp))
    assert got == raw
    assert got == bytes(zipnn_tpu.ZipNN(engine="tpu").decompress(comp))
    assert bytes(_port(engine="numpy").decompress(comp)) == raw


@pytest.mark.parametrize("kind", ["empty", "tiny", "all-stored", "all-rle"])
def test_decode_edge_containers(kind):
    raw = {
        "empty": b"", "tiny": b"\x01\x02\x03", "all-rle": bytes(3 * CHUNK + 10),
        "all-stored": np.random.default_rng(2).integers(
            0, 256, 3 * CHUNK + 11, dtype=np.uint8).tobytes(),
    }[kind]
    comp = _ref_container(raw, "bfloat16")
    assert bytes(_port(engine="cuda").decompress(comp)) == raw


def test_decode_across_batches(monkeypatch):
    """Several chunk-range batches: symbol rows are numbered per batch."""
    raw = _raw("bfloat16", 7 * CHUNK + 100, seed=5)
    comp = _ref_container(raw, "bfloat16")
    monkeypatch.setattr(decode, "batch_chunks", lambda chunk_size: 3)
    assert bytes(_port(engine="cuda").decompress(comp)) == raw


@pytest.mark.parametrize("profile", ["per_chunk", "shared"])
def test_pipeline_batches_ranges_and_staging(monkeypatch, profile):
    """A container in 4 batches (``BATCH_BYTES`` of 2 chunks): the batches'
    payload ranges tile the data region and hold every cell of their
    chunks; ``finish(start())``, ``stage`` + ``start_staged`` (twice) and a
    deferred check all give the reference's bytes."""
    raw = _raw("bfloat16", 7 * CHUNK + 100, seed=6)
    comp = _ref_container(raw, "bfloat16", huffman_table=profile)
    monkeypatch.setattr(decode, "BATCH_BYTES", 2 * CHUNK)
    z = _port(engine="cuda")
    after = z._retrieve_header(memoryview(comp))
    args = (memoryview(comp)[after:], 2, z._bit_reorder, z._byte_reorder,
            z.compression_chunk, z.original_len)
    g = decode.build_plan(*args).g
    batches = decode.plan_batches(g.n_chunks, g.chunk_size)
    assert len(batches) == 4
    covered = np.zeros(len(comp) - after, dtype=np.int64)
    for lo, hi in batches:
        ranges = decode.payload_ranges(g, lo, hi)
        assert len(ranges) <= 2
        mine = np.zeros_like(covered)
        for off, n in ranges:
            mine[off : off + n] += 1
        covered += mine
        for b in range(2):
            for c in range(lo, hi):
                s0, n = int(g.cell_start[b, c]), int(g.cell_size[b, c])
                assert mine[s0 : s0 + n].all()
    data_start = 2 * g.n_chunks * 9  # the chunk type and size tables
    assert not covered[:data_start].any() and (covered[data_start:] == 1).all()
    want = bytes(zipnn_tpu.ZipNN(engine="numpy").decompress(comp))
    assert want == raw
    assert decode.finish(decode.start(*args, device="cpu")).numpy().tobytes() == raw
    st = decode.stage(*args, device="cpu")
    for _ in range(2):
        assert decode.finish(decode.start_staged(st)).numpy().tobytes() == raw
    defer: list = []
    out = decode.finish(decode.start(*args, device="cpu", defer=defer))
    assert len(defer) == 1 and defer[0].bits.numel() == 4 * decode.build_plan(*args).n_huf
    decode.validate_deferred(defer)
    assert out.numpy().tobytes() == raw
    assert set(defer[0].timings) >= {"plan_s", "stage_s", "upload_s", "decoder"}


@pytest.mark.parametrize("name", ["bf16_gauss", "fp16_mixed", "fp8_gauss"])
def test_fixtures_decode_bit_exact(name):
    comp = (FIXDIR / f"{name}.znn").read_bytes()
    raw = (FIXDIR / f"{name}.raw").read_bytes()
    assert bytes(_port(engine="cuda").decompress(comp)) == raw


def test_fp32_fixture_numpy_engine_and_cuda_not_ported():
    """The libzstd-made fp32 fixture (4 planes, per-chunk tables) decodes
    bit-exactly in both engines."""
    comp = (FIXDIR / "fp32_gauss.znn").read_bytes()
    raw = (FIXDIR / "fp32_gauss.raw").read_bytes()
    assert bytes(_port(engine="numpy").decompress(comp)) == raw
    assert bytes(_port(engine="cuda").decompress(comp)) == raw
    assert decode.last_timings["decoder"] == "huf_pc_decode"


def test_shared_table_container_not_ported():
    """A shared-table container from ``zipnn_tpu`` decodes bit-exactly
    through the shared-table kernel's path."""
    raw = _raw("bfloat16", 4 * CHUNK, seed=11)
    comp = _ref_container(raw, "bfloat16", huffman_table="shared")
    assert bytes(_port(engine="cuda").decompress(comp)) == raw
    assert decode.last_timings["decoder"] == "huf_shared_decode"


DTYPES = ["bfloat16", "float16", "float8_e4m3fn", "float32"]


@pytest.mark.parametrize("profile", ["per_chunk", "shared"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_profiles_match_reference(dtype, profile):
    nbytes = 3 * CHUNK + 4 * 97 + 3
    raw = _raw(dtype, nbytes, seed=len(dtype))
    comp = _ref_container(raw, dtype, huffman_table=profile)
    got = bytes(_port(engine="cuda").decompress(comp))
    assert got == raw
    assert got == bytes(zipnn_tpu.ZipNN(engine="numpy").decompress(comp))
    if profile == "shared":
        assert decode.last_timings["decoder"] == "huf_shared_decode"


def _unseen_byte_case(n_chunks: int, chunk: int) -> bytes:
    """bf16 whose chunk 3 (never sampled at stride 8) holds an exponent
    byte no sampled chunk has."""
    raw = bytearray(_raw("bfloat16", n_chunks * chunk, seed=7))
    raw[3 * chunk + 1] = 0x7F  # high byte of the first value in chunk 3
    assert not any(raw[c * chunk + 1 :: 2][: chunk // 2].count(0x7F)
                   for c in range(0, n_chunks, 8))
    return bytes(raw)


@pytest.mark.parametrize("stride", [1, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_encoder_byte_identical(dtype, stride):
    chunk = CHUNK if stride == 1 else 1024
    n_chunks = 3 if stride == 1 else 520
    raw = _raw(dtype, n_chunks * chunk - 5, seed=stride)
    if stride == 8 and dtype == "bfloat16":
        raw = _unseen_byte_case(n_chunks, chunk)
    assert zipnn_tpu_torch.codec.shared_sample_stride(n_chunks) == stride
    kw = dict(bytearray_dtype=dtype, compression_chunk=chunk, huffman_table="shared")
    want = bytes(zipnn_tpu.ZipNN(engine="numpy", **kw).compress(raw))
    engine = "numpy" if stride == 1 else "cuda"  # the golden and the device encoder
    assert _port(engine=engine, **kw).compress(raw) == want
    if stride == 1:  # the payload, and the same from tables passed in
        codec = zipnn_tpu_torch.codec
        gr = dtypes.grouping_for_code(dtypes.from_any(dtype).code)
        geo = (gr.num_buf, gr.bit_reorder, gr.byte_reorder,
               codec.effective_chunk(chunk, gr.num_buf))
        arr = np.frombuffer(raw, np.uint8)
        payload = codec.compress_payload_numpy(arr, *geo, shared_tables=True)
        assert want.endswith(payload)
        preset = codec.shared_plane_tables(arr, *geo, codec.DEFAULT_THRESHOLD)
        assert codec.compress_payload_numpy(
            arr, *geo, shared_tables=True, preset_shared=preset) == payload
    if stride == 1:
        assert bytes(_port(engine="cuda").decompress(want)) == raw
    elif dtype == "bfloat16":
        types = np.frombuffer(want[32 : 32 + 2 * n_chunks], np.uint8).reshape(2, n_chunks)
        assert types[1, 3] == 0 and types[1, 4] == 1  # the unseen byte stores raw


@pytest.mark.parametrize("profile", ["per_chunk", "shared"])
@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_chunks_below_a_word(dtype, chunk, profile):
    """Chunks of 1 and 2 bytes (cells stored or RLE, never Huffman) start
    off word boundaries: K2 fills them byte by byte.  Where a chunk is
    smaller than a value (bf16, fp16 and fp32 at 1 byte, fp32 at 2), the
    reference's readers refuse the container its encoder wrote (their
    full-chunk cell lengths are ``chunk // planes``); the port reads the
    lengths the encoder wrote, and the numpy engine agrees."""
    raw = _raw(dtype, 4 * 75 + 2, seed=chunk)
    comp = _ref_container(raw, dtype, compression_chunk=chunk, huffman_table=profile)
    for engine in ("cuda", "numpy"):
        assert bytes(_port(engine=engine).decompress(comp)) == raw, engine
    if chunk % dtypes.grouping_for_code(dtypes.from_any(dtype).code).num_buf == 0:
        assert bytes(zipnn_tpu.ZipNN(engine="numpy").decompress(comp)) == raw


def test_per_chunk_container_with_one_shared_header_takes_k6():
    """Per-chunk tables that happen to agree (every chunk a permutation of
    the first) take the shared-table kernel, like the JAX package's
    ``_SharedPlan``."""
    rng = np.random.default_rng(8)
    first = rng.integers(40, 72, CHUNK).astype(np.uint8)  # 5-bit codes
    raw = np.concatenate([rng.permutation(first) for _ in range(4)]).tobytes()
    comp = _ref_container(raw, "float8_e4m3fn")
    z = _port(engine="cuda")
    after = z._retrieve_header(memoryview(comp))
    plan = decode.build_plan(memoryview(comp)[after:], 1, z._bit_reorder,
                             z._byte_reorder, z.compression_chunk, z.original_len)
    assert plan.n_huf == 4 and plan.shared and plan.tlog_k <= 8
    assert bytes(_port(engine="cuda").decompress(comp)) == raw
    assert decode.last_timings["decoder"] == "huf_shared_decode"


@pytest.mark.parametrize("fmt,dtype,nbytes,kw", [
    ("byte", "bfloat16", 5 * CHUNK + 6002, {}),
    ("byte", "float16", 3 * CHUNK + 2, {"check_th_after_percent": 0}),
    ("byte", "float8_e4m3fn", 9 * CHUNK + 1, {"compression_chunk": 2 * CHUNK}),
    ("byte", "float32", 3 * CHUNK + 400, {}),
    ("torch", "bfloat16", 2 * CHUNK + 12, {}),
    ("numpy", "float16", 2 * CHUNK + 12, {}),
    ("byte", "random", 12 * CHUNK, {}),  # planes abandoned by the bounded check
])
def test_golden_encoder_byte_identical(fmt, dtype, nbytes, kw):
    kw = dict(kw)
    kw.setdefault("compression_chunk", CHUNK)
    if dtype == "random":
        raw = np.random.default_rng(1).integers(0, 256, nbytes, dtype=np.uint8).tobytes()
        dtype = "bfloat16"
    else:
        raw = _raw(dtype, nbytes, seed=nbytes)
    if fmt == "byte":
        data_ref = data_port = raw
        kw["bytearray_dtype"] = dtype
    elif fmt == "torch":
        data_ref = data_port = torch.frombuffer(bytearray(raw), dtype=torch.uint16).view(
            torch.bfloat16).reshape(-1, 2)[:, :1]
    else:
        data_ref = data_port = np.frombuffer(raw, np.float16).reshape(2, -1)
    want = bytes(zipnn_tpu.ZipNN(engine="numpy", input_format=fmt, **kw).compress(data_ref))
    for engine in ("numpy", "cuda"):
        got = _port(engine=engine, input_format=fmt, **kw).compress(data_port)
        assert got == want, (engine, fmt, dtype)


def test_torch_format_returns_tensor_on_device():
    x = torch.from_numpy(np.frombuffer(_raw("bfloat16", 3 * CHUNK + 6, 3), np.uint16).copy())
    x = x.view(torch.bfloat16).reshape(3, -1)
    comp = _port(input_format="torch", engine="numpy").compress(x)
    y = _port(input_format="torch", engine="cuda").decompress(comp)
    assert y.device.type == "cpu" and y.dtype == torch.bfloat16 and y.shape == x.shape
    assert torch.equal(y.view(torch.int16), x.view(torch.int16))
    z = _port(engine="cuda")
    z.decompress(comp)
    assert z.last_stats.op == "decompress" and z.last_stats.engine == "cuda"
    n = _port(input_format="numpy", engine="numpy").compress(np.arange(10, dtype=np.float16))
    np.testing.assert_array_equal(
        _port(engine="cuda").decompress(n), np.arange(10, dtype=np.float16)
    )


def _stream_bit_flips(comp: bytes, stream_index: int):
    """Yield containers with one bit flipped inside the given stream."""
    z = _port(engine="cuda")
    after = z._retrieve_header(memoryview(comp))
    plan = decode.build_plan(memoryview(comp)[after:], 2, z._bit_reorder,
                             z._byte_reorder, z.compression_chunk, z.original_len)
    s0 = after + int(plan.starts[stream_index])
    ln = int(plan.lens[stream_index])
    for bit in range(8 * (ln // 2), 8 * (ln - 1)):
        bad = bytearray(comp)
        bad[s0 + bit // 8] ^= 1 << (bit % 8)
        yield bytes(bad)


def test_corrupt_stream_located_like_reference():
    raw = _raw("bfloat16", 3 * CHUNK, seed=21)
    comp = _ref_container(raw, "bfloat16")
    for bad in _stream_bit_flips(comp, 4 * 2 + 3):  # stream 3 of HUF cell 2
        try:
            zipnn_tpu.ZipNN(engine="tpu").decompress(bad)
        except RefCorrupt as exc:
            ref = exc
            break
    else:
        pytest.fail("no rejected bit flip found")
    with pytest.raises(CorruptChunkError) as got:
        _port(engine="cuda").decompress(bad)
    assert (got.value.plane, got.value.chunk, got.value.stream) == (
        ref.plane, ref.chunk, ref.stream)
    assert ref.stream == 3


def test_corrupt_shared_stream_located_like_reference():
    raw = _raw("bfloat16", 3 * CHUNK, seed=22)
    comp = _ref_container(raw, "bfloat16", huffman_table="shared")
    for bad in _stream_bit_flips(comp, 4 * 1 + 2):  # stream 2 of HUF cell 1
        try:
            zipnn_tpu.ZipNN(engine="tpu").decompress(bad)
        except RefCorrupt as exc:
            ref = exc
            break
    else:
        pytest.fail("no rejected bit flip found")
    with pytest.raises(CorruptChunkError) as got:
        _port(engine="cuda").decompress(bad)
    assert decode.last_timings["decoder"] == "huf_shared_decode"
    assert (got.value.plane, got.value.chunk, got.value.stream) == (
        ref.plane, ref.chunk, ref.stream)
    assert ref.stream == 2


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ZipNN(engine="cuda")  # device defaults to the card
    comp = (FIXDIR / "bf16_gauss.znn").read_bytes()
    with pytest.raises(RuntimeError, match="CUDA"):
        zipnn_tpu_torch.codec.decompress_payload(
            memoryview(comp)[32:], 2, 1, 10, 1 << 18, 600000, "cuda", device="cuda")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = [
        f for f in sorted((ROOT / "zipnn_tpu_torch").rglob("*.py"))
        if "_build" not in f.parts  # kernel build outputs, not the package
    ] + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "zipnn_tpu"), f"{f}: imports {name}"


def test_import_and_roundtrip_leave_jax_unloaded():
    code = (
        "import sys, json, numpy as np\n"
        "import zipnn_tpu_torch\n"
        "raw = np.arange(70000, dtype=np.uint16).tobytes()\n"
        "z = zipnn_tpu_torch.ZipNN(engine='cuda', device='cpu', compression_chunk=16384)\n"
        "assert bytes(z.decompress(z.compress(raw))) == raw\n"
        "from zipnn_tpu_torch.io.serving import ShardDecoder\n"
        "assert list(ShardDecoder(device='cpu').decompress_iter([z.compress(raw)])) == [raw]\n"
        "from zipnn_tpu_torch.io.serving import ShardEncoder\n"
        "assert ShardEncoder(z).compress_all([raw]) == [z.compress(raw)]\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zipnn_tpu'))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []

