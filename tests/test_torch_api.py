"""PyTorch port: ``ZipNN`` API parity with the JAX package on the CPU.

Every mode of the JAX package's ``ZipNN`` -- streaming frames at three
``streaming_chunk`` sizes, delta (byte and file), streaming + delta,
lossy INTEGER (fp32 on the int32 path, bf16 on the int16 path, and an
input out of range, which stores as a float), the whole-buffer zstd path
and ``engine="auto"`` -- writes containers byte-equal to
``zipnn_tpu.ZipNN(engine="numpy")``'s, and each package decodes the
other's.  The port runs ``engine="cuda"`` on ``device="cpu"`` (the
kernels' plain versions).  Port-only checks: the reference's error cases
(``tests/test_zipnn_api.py``), ``metadata`` / ``__metadata__``, the
reference's double-header whole-buffer frames, and that a streaming
container's frames decode as one plan with fewer decode-kernel calls than
frames.
"""
import numpy as np
import pytest
import torch

import zipnn_tpu
from zipnn_tpu_torch import ZipNN, native
from zipnn_tpu_torch.ops import decode, huf_pc

KB = 1024
CHUNK = 16384
PLAIN = {"engine": "cuda", "device": "cpu"}


def _bf16(n_bytes, seed=0):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(n_bytes // 2 + 1) * 0.05).astype(np.float32)
    return ((vals.view(np.uint32) >> 16).astype("<u2")).tobytes()[:n_bytes]


def _tweaked(data, seed=1):
    """``data`` with every 97th byte changed: a fine-tuned copy."""
    out = bytearray(data)
    out[::97] = np.random.default_rng(seed).integers(0, 256, len(out[::97]), np.uint8).tobytes()
    return bytes(out)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return bytes(a) == bytes(b)


def _f32(shape, scale, seed):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


BASE = _bf16(150 * KB + 7, seed=3)
STREAM = {"is_streaming": True, "compression_chunk": CHUNK}
LOSSY = {"input_format": "torch", "lossy_compressed_type": "integer"}

# (knobs, data, delta base) of each mode; a delta base of "file" is
# written to a file and passed by path
CASES = {
    "streaming_4k": ({**STREAM, "streaming_chunk": 4096}, _bf16(40 * KB + 3, 4), None),
    "streaming_32k": ({**STREAM, "streaming_chunk": 32768}, _bf16(150 * KB + 5, 5), None),
    "streaming_1m": ({**STREAM, "streaming_chunk": 1 << 20}, _bf16(150 * KB + 5, 6), None),
    "delta_byte": ({"delta_compressed_type": "byte"}, _tweaked(BASE), BASE),
    "delta_file": ({"delta_compressed_type": "file"}, _tweaked(BASE), "file"),
    "streaming_delta": ({**STREAM, "streaming_chunk": 32768, "delta_compressed_type": "byte"},
                        _tweaked(BASE), BASE),
    "lossy_fp32": ({**LOSSY, "compression_chunk": CHUNK}, _f32((96, 130), 0.05, 7), None),
    "lossy_bf16": ({**LOSSY, "lossy_compressed_factor": 8, "compression_chunk": CHUNK},
                   _f32((64, 130), 0.05, 8).to(torch.bfloat16), None),
    "lossy_out_of_range": ({**LOSSY}, _f32((32, 40), 1e30, 9), None),
    "vanilla_zstd": ({"method": "zstd", "byte_reorder": 0b0_00_01_001}, _bf16(64 * KB, 10), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_containers_match_reference(case, tmp_path):
    kw, data, base = CASES[case]
    if base == "file":
        path = tmp_path / "base.bin"
        path.write_bytes(BASE)
        base = str(path)
    call = {} if base is None else {"delta_second_data": base}
    want = bytes(zipnn_tpu.ZipNN(engine="numpy", **kw).compress(data, **call))
    got = bytes(ZipNN(**PLAIN, **kw).compress(data, **call))
    assert got == want
    ref_back = zipnn_tpu.ZipNN(engine="numpy", **kw).decompress(got, **call)
    port_back = ZipNN(**PLAIN, **kw).decompress(want, **call)
    assert _equal(port_back, ref_back)
    if kw.get("lossy_compressed_type") is None:
        assert _equal(port_back, data)
    elif case == "lossy_out_of_range":
        assert torch.equal(port_back, data)
    if kw.get("is_streaming"):
        assert bytes(ZipNN(**{**kw, "engine": "native"}).compress(data, **call)) == want


def test_lossy_fp32_takes_int32_planes_without_rotation():
    _, t, _ = CASES["lossy_fp32"]
    c = bytes(ZipNN(**PLAIN, **LOSSY).compress(t))
    assert (c[5], c[6], c[10], c[11], c[12], c[15]) == (220, 0, 1, 27, 1, 1)
    back = ZipNN(**PLAIN).decompress(c)
    # one step (2**-27) of truncation, and up to two more from float32's
    # rounding of integers below 2**26 (|x| < 0.5)
    assert back.dtype == torch.float32 and float((back - t).abs().max()) <= 2.0 ** -25


def test_vanilla_reference_double_header_reads():
    """The reference's whole-buffer writer emits the 32-byte header twice,
    only the outer copy's total_len updated (reference zipnn.py:700-703);
    the port reads such a frame and its own single-header one."""
    kw = {"method": "zstd", "byte_reorder": 0b0_00_01_001}
    data = CASES["vanilla_zstd"][1]
    ours = bytes(ZipNN(**PLAIN, **kw).compress(data))
    outer, body = bytearray(ours[:32]), ours[32:]
    inner = bytearray(outer)
    inner[24:32] = bytes(8)
    ba_comp = bytes(inner) + body
    outer[24:32] = (len(ba_comp) + 32).to_bytes(8, "little")
    for frame in (bytes(outer) + ba_comp, ours):
        assert bytes(ZipNN(**PLAIN, **kw).decompress(frame)) == data


def test_engine_auto_is_native_and_does_not_fall_back(monkeypatch):
    data = _bf16(70 * KB, 11)
    want = bytes(zipnn_tpu.ZipNN(engine="numpy").compress(data))
    z = ZipNN(engine="auto")
    assert bytes(z.compress(data)) == want and z.last_stats.engine == "native"
    assert bytes(z.decompress(want)) == data and z.last_stats.engine == "native"

    def broken():
        raise native.NativeBuildError("g++ failed")

    monkeypatch.setattr(native, "lib", broken)
    with pytest.raises(native.NativeBuildError):
        ZipNN(engine="auto").compress(data)
    with pytest.raises(native.NativeBuildError):
        ZipNN(engine="auto").decompress(want)


def test_streaming_frames_decode_in_one_plan(monkeypatch):
    """The frames of a streaming container decode as one container: one
    host plan and one decode-kernel call per batch (here one), not one per
    frame; chunks of 4 KB < frames of 8 KB, and frames of 8 KB < chunks."""
    data = _bf16(300 * KB + 11, 12)
    calls = {"plan": 0, "k1": 0}
    build, k1 = decode.build_plan, huf_pc.huf_pc_decode

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(decode, "build_plan", count("plan", build))
    monkeypatch.setattr(huf_pc, "huf_pc_decode", count("k1", k1))
    for chunk in (4096, 65536):
        c = bytes(zipnn_tpu.ZipNN(engine="numpy", is_streaming=True, streaming_chunk=8192,
                                  compression_chunk=chunk).compress(data))
        calls.update(plan=0, k1=0)
        assert bytes(ZipNN(**PLAIN, is_streaming=True).decompress(c)) == data
        frames = decode.last_timings["frames"]
        assert frames == -(-len(data) // 8192) == 38
        assert calls == {"plan": 1, "k1": 1} and decode.last_timings["runs"] == 1


ERRORS = {
    "chunk_not_power_of_2": lambda: ZipNN(**PLAIN, compression_chunk=1000),
    "streaming_chunk_not_power_of_2": lambda: ZipNN(**PLAIN, streaming_chunk=999),
    "streaming_needs_bytes": lambda: ZipNN(**PLAIN, input_format="torch", is_streaming=True),
    "file_format": lambda: ZipNN(**PLAIN, input_format="file"),
    "lossy_needs_torch": lambda: ZipNN(**PLAIN, lossy_compressed_type="integer"),
    "lossy_unsign": lambda: ZipNN(**PLAIN, input_format="torch", lossy_compressed_type="unsign")
    .compress(torch.randn(8, 8)),
    "lz4_missing": lambda: ZipNN(**PLAIN, method="lz4"),
    "snappy_missing": lambda: ZipNN(**PLAIN, method="snappy"),
    "bad_magic": lambda: ZipNN(**PLAIN).decompress(b"XX" + bytes(64)),
    "delta_length": lambda: ZipNN(**PLAIN, delta_compressed_type="byte").compress(
        BASE, delta_second_data=BASE[:-1]),
    "delta_without_knob": lambda: ZipNN(**PLAIN).compress(BASE, delta_second_data=BASE),
    "delta_file_missing": lambda: ZipNN(**PLAIN, delta_compressed_type="file").compress(
        BASE, delta_second_data="/nonexistent/base.bin"),
    "delta_decode_without_base": lambda: ZipNN(**PLAIN, delta_compressed_type="byte")
    .decompress(CASES["delta_byte"][1]),
    "not_delta_container": lambda: ZipNN(**PLAIN, delta_compressed_type="byte").decompress(
        bytes(ZipNN(**PLAIN).compress(BASE)), delta_second_data=BASE),
    "delta_container_plain_decode": lambda: ZipNN(**PLAIN).decompress(bytes(
        ZipNN(**PLAIN, delta_compressed_type="byte").compress(BASE, delta_second_data=BASE))),
    "delta_decode_length": lambda: ZipNN(**PLAIN, delta_compressed_type="byte").decompress(
        bytes(ZipNN(**PLAIN, delta_compressed_type="byte").compress(
            BASE, delta_second_data=BASE)), delta_second_data=BASE[:-2]),
    "integer_input": lambda: ZipNN(**PLAIN, input_format="torch").compress(
        torch.arange(10, dtype=torch.int32)),
    "vanilla_torch_decode": lambda: ZipNN(**PLAIN).decompress(bytes(ZipNN(
        **PLAIN, input_format="torch", method="zstd", byte_reorder=0b0_00_01_001).compress(
        torch.randn(64, 8).to(torch.bfloat16)))),
}
ERROR_TYPES = {"lz4_missing": ImportError, "snappy_missing": ImportError,
               "delta_file_missing": FileNotFoundError}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_reference(case):
    """Each error case raises the reference's exception type, with the
    reference's message where the reference raises it too."""
    exc = ERROR_TYPES.get(case, ValueError)
    with pytest.raises(exc) as got:
        ERRORS[case]()
    ref_call = {
        "chunk_not_power_of_2": lambda: zipnn_tpu.ZipNN(compression_chunk=1000),
        "lossy_needs_torch": lambda: zipnn_tpu.ZipNN(lossy_compressed_type="integer"),
        "delta_length": lambda: zipnn_tpu.ZipNN(delta_compressed_type="byte").compress(
            BASE, delta_second_data=BASE[:-1]),
        "not_delta_container": lambda: zipnn_tpu.ZipNN(delta_compressed_type="byte").decompress(
            bytes(ZipNN(**PLAIN).compress(BASE)), delta_second_data=BASE),
    }.get(case)
    if ref_call is not None:
        with pytest.raises(exc) as ref:
            ref_call()
        assert str(got.value) == str(ref.value)


def test_metadata_matches_reference(tmp_path, capsys):
    t = torch.randn(8, 8, dtype=torch.bfloat16)
    c = bytes(ZipNN(**PLAIN, input_format="torch").compress(t))
    meta = ZipNN(**PLAIN).metadata(c)
    assert meta == zipnn_tpu.ZipNN().metadata(c)
    assert meta["dtype"] == "BFLOAT16" and meta["shape_bytes"] == (8, 8)
    p = tmp_path / "x.znn"
    p.write_bytes(c)
    assert ZipNN(**PLAIN).metadata(str(p)) == meta
    assert ZipNN(**PLAIN).metadata(str(p), version=True) is None
    assert capsys.readouterr().out.splitlines()[-1] == "ZipNN version: 0.5.3"
    kw = {"is_streaming": True, "delta_compressed_type": "byte", "threads": 3}
    ours = ZipNN(**PLAIN, **kw).__metadata__()
    ref = zipnn_tpu.ZipNN(engine="numpy", **kw).__metadata__()
    assert ours.pop("Device") == "cpu" and ours.pop("Engine") == "cuda"
    ref.pop("Engine")
    lossy = "Lossy compressed type"
    assert ours.pop(lossy).name == ref.pop(lossy).name == "NONE"
    assert ours == ref


def test_files_read_and_write(tmp_path):
    data = _bf16(50 * KB, 13)
    c = tmp_path / "x.znn"
    c.write_bytes(bytes(zipnn_tpu.ZipNN(engine="numpy").compress(data)))
    z = ZipNN(**PLAIN, compressed_file=str(c), decompressed_file=str(tmp_path / "x.raw"))
    assert z.write_bin(z.decompress_read_file()) == 0
    assert (tmp_path / "x.raw").read_bytes() == data
    with pytest.raises(FileNotFoundError):
        z.decompress_read_file(str(tmp_path / "missing.znn"))
