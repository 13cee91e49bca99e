"""PyTorch port, the whole slice: ``zipnn_tpu_torch.ZipNN`` against
``zipnn_tpu``.

* decode: the port (``engine="cuda"``, ``device="cpu"``, so the kernels'
  plain versions run) against ``zipnn_tpu.ZipNN(engine="tpu")`` and
  ``engine="numpy"`` and the committed libzstd-made fixtures, bit-exact;
* encode: the port's golden encoder writes the same container bytes as
  ``zipnn_tpu``'s ``engine="numpy"``;
* errors: a flipped stream bit raises at the same (plane, chunk, stream)
  as ``zipnn_tpu``; fp32 and shared-table containers and a missing GPU
  raise instead of taking a host path;
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


@pytest.mark.parametrize("name", ["bf16_gauss", "fp16_mixed", "fp8_gauss"])
def test_fixtures_decode_bit_exact(name):
    comp = (FIXDIR / f"{name}.znn").read_bytes()
    raw = (FIXDIR / f"{name}.raw").read_bytes()
    assert bytes(_port(engine="cuda").decompress(comp)) == raw


def test_fp32_fixture_numpy_engine_and_cuda_not_ported():
    comp = (FIXDIR / "fp32_gauss.znn").read_bytes()
    raw = (FIXDIR / "fp32_gauss.raw").read_bytes()
    assert bytes(_port(engine="numpy").decompress(comp)) == raw
    with pytest.raises(NotImplementedError, match="M4"):
        _port(engine="cuda").decompress(comp)


def test_shared_table_container_not_ported():
    raw = _raw("bfloat16", 4 * CHUNK, seed=11)
    comp = _ref_container(raw, "bfloat16", huffman_table="shared")
    with pytest.raises(NotImplementedError, match="M5"):
        _port(engine="cuda").decompress(comp)


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
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zipnn_tpu'))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []

