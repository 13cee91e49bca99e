"""PyTorch port: the observability layer (``zipnn_tpu_torch/stats.py``),
held against the JAX package's ``zipnn_tpu.stats``.

Mirrors ``tests/test_stats.py`` (``CodecStats`` of both ops, the per-plane
histogram of ``frame_stats``, a trace written by ``trace``), and adds:
``frame_stats`` and ``file_stats`` equal to the reference's on per-chunk,
shared, fp32, streaming multi-frame, whole-buffer zstd and empty
containers; a CPU trace of ``ZipNN(device="cpu")`` compress and
decompress that holds the codec's ``znn:`` spans; and a CPU trace of a
staged ``ShardDecoder.decompress_stacked`` whose ``znn:decode:*`` spans
nest as the serving path's do.  The card's trace is in
``test_torch_cuda.py`` and ``chip_smoke.py`` phase 13.
"""
import json

import numpy as np
import pytest

import zipnn_tpu
from zipnn_tpu import stats as ref_stats
from zipnn_tpu_torch import ZipNN, stats

RNG = np.random.default_rng(11)


def _bf16_bytes(n):
    vals = (RNG.standard_normal(n // 2) * 0.05).astype(np.float32)
    return ((vals.view(np.uint32) >> 16).astype(np.uint16)).tobytes()[:n]


def test_last_stats_records_both_ops():
    data = _bf16_bytes(1 << 20)
    z = ZipNN(engine="native")
    comp = z.compress(data)
    s = z.last_stats
    assert s.op == "compress"
    assert s.original_bytes == len(data)
    assert s.compressed_bytes == len(comp)
    assert 0 < s.ratio < 1
    assert s.throughput_GBps > 0
    z.decompress(bytes(comp))
    assert z.last_stats.op == "decompress"


def test_payload_stats_plane_histogram():
    data = _bf16_bytes(1 << 20)
    comp = ZipNN(engine="native").compress(data)
    info = stats.frame_stats(bytes(comp))
    assert info["planes"], info
    per_plane = {p["plane"]: p for p in info["planes"]}
    # bf16 LE gaussian weights: plane 0 (mantissa bytes) stays raw,
    # plane 1 (sign-rotated exponent bytes) huffmans
    assert per_plane[1]["huffman_chunks"] > 0
    assert per_plane[0]["raw_chunks"] > 0
    total = sum(p["compressed_bytes"] for p in info["planes"])
    assert 0 < total < len(data)


def test_trace_contextmanager(tmp_path):
    data = _bf16_bytes(1 << 18)
    with stats.trace(str(tmp_path), label="test") as prof:
        ZipNN(engine="native").compress(data)
    assert "test" in {e.key for e in prof.key_averages()}
    assert list(tmp_path.glob("*.pt.trace.json")), "no trace written"


CONTAINERS = {
    "per_chunk": dict(compression_chunk=16384),
    "shared": dict(compression_chunk=16384, huffman_table="shared"),
    "fp32": dict(compression_chunk=16384, bytearray_dtype="float32"),
    "streaming": dict(compression_chunk=16384, is_streaming=True, streaming_chunk=65536),
    "zstd": dict(byte_reorder=0b0_00_01_001),
    "empty": dict(),
}


@pytest.mark.parametrize("case", list(CONTAINERS))
def test_frame_and_file_stats_equal_reference(case):
    """Both packages read the same container (the port's engine native
    writes it) to the same dicts."""
    if case == "zstd":
        pytest.importorskip("zstandard")
    data = b"" if case == "empty" else _bf16_bytes(200_000)
    comp = bytes(ZipNN(engine="native", **CONTAINERS[case]).compress(data))
    assert comp == bytes(zipnn_tpu.ZipNN(engine="numpy", **CONTAINERS[case]).compress(data))
    got = stats.file_stats(comp)
    assert got == ref_stats.file_stats(comp)
    assert len(got["frames"]) == (4 if case == "streaming" else 1)
    if case != "streaming":
        assert stats.frame_stats(comp) == ref_stats.frame_stats(comp)


def test_cpu_trace_holds_codec_spans(tmp_path):
    """A trace of ``ZipNN(device="cpu")`` (the kernels' plain versions)
    holds the encoder's and decoder's ``znn:`` spans."""
    data = _bf16_bytes(8300)
    z = ZipNN(engine="cuda", device="cpu", compression_chunk=4096)
    with stats.trace(str(tmp_path)) as prof:
        comp = z.compress(data)
        assert bytes(z.decompress(comp)) == data
    keys = {e.key for e in prof.key_averages()}
    for span in ("encode:split", "encode:hist", "encode:plan", "encode:kernel",
                 "encode:decide", "encode:assemble", "encode:splice",
                 "decode:plan", "decode:geometry", "decode:plan-tables"):
        assert f"znn:{span}" in keys, (span, sorted(k for k in keys if k.startswith("znn:")))


def test_stacked_decode_spans_nest(tmp_path):
    """A traced staged decode of 3 containers of one geometry on the CPU:
    bit-exact; the unit's one ``znn:decode:alloc`` before its launch
    set's ``znn:decode:enqueue``; one ``znn:decode:validate`` after it
    holds the ``znn:decode:bits_fetch``; all inside one
    ``znn:decode:stacked``."""
    from zipnn_tpu_torch.io.serving import ShardDecoder  # noqa: PLC0415

    datas = [_bf16_bytes(40_000 + 6 * i) for i in range(3)]
    dec = ShardDecoder(device="cpu", to_device=True)
    stk = dec.stack([dec.stage(ZipNN(engine="native", compression_chunk=16384).compress(d))
                     for d in datas])
    with stats.trace(str(tmp_path)):
        outs = dec.decompress_stacked(stk)
    assert [o.numpy().tobytes() for o in outs] == datas
    (path,) = tmp_path.glob("*.pt.trace.json")
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith("znn:decode:")):
            spans.setdefault(e["name"][11:], []).append((e["ts"], e["ts"] + e["dur"]))

    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1]

    assert sorted(spans) == ["alloc", "bits_fetch", "enqueue", "stacked", "validate"]
    (stacked,), (validate,), (fetch,) = spans["stacked"], spans["validate"], spans["bits_fetch"]
    (alloc,) = spans["alloc"]
    enqueues = sorted(spans["enqueue"])
    assert len(enqueues) == 1
    assert inside(alloc, stacked) and alloc[1] <= enqueues[0][0]
    for e in enqueues:
        assert inside(e, stacked)
    assert inside(validate, stacked) and inside(fetch, validate)
    assert validate[0] >= enqueues[-1][1]


def test_phase_passes_exceptions_on():
    with pytest.raises(KeyError):
        with stats.phase("x"):
            raise KeyError("inside")
