"""PyTorch port: the codec split over a device mesh
(``zipnn_tpu_torch.parallel.sharded``), the encode inputs of the
multi-process paths (``raw_planes``, ``preset_shared``, the sampled
counts) and the port's entry module, on the CPU, held against the JAX
package.

Mirrors ``tests/test_parallel.py``: the meshes are ``["cpu"] * k`` (a mesh
may repeat a device; each entry is a shard), and ``"cpu:0"`` entries, which
compare unequal to the call's ``"cpu"`` device, take the paths of a shard
on another device than the output.  The card's run is in
``test_torch_cuda.py`` and ``chip_smoke.py`` phase 14.
"""
import jax
import numpy as np
import pytest
import torch

from zipnn_tpu import codec as ref_codec
from zipnn_tpu import parallel as ref_parallel
from zipnn_tpu_torch import ZipNN, codec, entry, native
from zipnn_tpu_torch.io.serving import ShardDecoder
from zipnn_tpu_torch.ops import combine, decode, encode, hist, huf_enc, huf_pc, huf_shared
from zipnn_tpu_torch.ops import transforms
from zipnn_tpu_torch.ops.entropy import huf
from zipnn_tpu_torch.parallel import make_mesh, sharded, use_mesh

CHUNK = 8192


def _bf16ish(n, seed=3):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(n // 2 + 1) * 0.05).astype(np.float32)
    return ((vals.view(np.uint32) >> 16).astype(np.uint16)).view(np.uint8)[:n].copy()


def _fp32ish(n, seed=4):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(n // 4 + 1) * 0.05).astype(np.float32)
    return vals.view(np.uint8)[:n].copy()


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_equals_reference(n):
    ref = ref_parallel.make_mesh(jax.devices()[:n])
    mesh = make_mesh(["cpu"] * n)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert dict(mesh.shape) == dict(ref.shape)
    assert mesh.devices.shape == ref.devices.shape


def test_make_mesh_refuses_what_it_cannot_run():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError):
        make_mesh([])


# (dtype, num_buf, bit_reorder, byte_reorder, bytes)
LAYOUTS = {"bf16": (_bf16ish, 2, 1, 10, CHUNK * 11 + 77),
           "fp32": (_fp32ish, 4, 1, 220, CHUNK * 11 + 76)}
MESHES = {"2": ["cpu"] * 2, "8": ["cpu"] * 8, "16 (more shards than chunks)": ["cpu"] * 16,
          "cpu:0 beside cpu": ["cpu:0", "cpu", "cpu:0"]}


@pytest.mark.parametrize("shared", [False, True], ids=["per_chunk", "shared"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_payload_equals_reference(mesh, layout, shared):
    """Under a mesh, the cuda engine's payload (the kernels' plain versions)
    equals the JAX package's golden encoder's, and the payload decodes
    back under the mesh."""
    make, nb, br, byr, n = LAYOUTS[layout]
    data = make(n)
    want = ref_codec.compress_payload_numpy(data, nb, br, byr, CHUNK, shared_tables=shared)
    with use_mesh(make_mesh(MESHES[mesh])):
        got = codec.compress_payload(data, nb, br, byr, CHUNK, engine="cuda", device="cpu",
                                     shared_tables=shared)
        back = codec.decompress_payload(want, nb, br, byr, CHUNK, n, engine="cuda",
                                        device="cpu")
    assert got == want
    assert np.array_equal(back.numpy(), data)


def test_sharded_decode_of_small_chunks_keeps_word_boundaries():
    """Chunks of 1 and 2 bytes: each shard's output starts on a word
    boundary (K2 writes whole words), and the bytes come back."""
    data = _bf16ish(999, seed=8)
    with use_mesh(make_mesh(["cpu:0", "cpu"] * 2)):
        for chunk in (1, 2, 4):
            comp = ZipNN(engine="numpy", compression_chunk=chunk).compress(bytes(data))
            back = ZipNN(engine="cuda", device="cpu").decompress(comp)
            assert bytes(back) == data.tobytes()


def test_sharded_encode_launches_on_every_shard(monkeypatch):
    """Each shard's split runs on its own device: the encode asks the
    source for every shard's chunk range, in order."""
    seen = []
    batch = encode.Source.batch

    def spy(self, lo, hi, device):
        seen.append((str(device), lo, hi))
        return batch(self, lo, hi, device)

    monkeypatch.setattr(encode.Source, "batch", spy)
    data = _bf16ish(CHUNK * 10)
    with use_mesh(make_mesh(["cpu:0", "cpu", "cpu"])):
        codec.compress_payload(data, 2, 1, 10, CHUNK, engine="cuda", device="cpu")
    assert seen == [("cpu:0", 0, 4), ("cpu", 4, 7), ("cpu", 7, 10)]


def test_staged_replay_refuses_a_mesh():
    comp = ZipNN(engine="numpy", compression_chunk=CHUNK).compress(bytes(_bf16ish(CHUNK * 3)))
    dec = ShardDecoder(device="cpu")
    with use_mesh(make_mesh(["cpu"] * 2)):
        with pytest.raises(ValueError, match="mesh"):
            dec.stage(comp)
    st = dec.stage(comp)
    with use_mesh(make_mesh(["cpu"] * 2)):
        with pytest.raises(ValueError, match="mesh"):
            dec.start_staged(st)


def test_callers_under_a_mesh():
    """``ZipNN`` (torch tensors, both profiles, streaming bytes) and one
    ``ShardDecoder`` load run under a mesh and equal the calls with no
    mesh."""
    t = torch.from_numpy(_bf16ish(CHUNK * 13 + 6)).view(torch.bfloat16)
    raw = _bf16ish(CHUNK * 9 + 5, seed=5).tobytes()
    card = dict(input_format="torch", engine="cuda", device="cpu", compression_chunk=CHUNK)
    plain = [bytes(ZipNN(**card, huffman_table=p).compress(t)) for p in ("per_chunk", "shared")]
    stream = dict(engine="cuda", device="cpu", compression_chunk=CHUNK, is_streaming=True,
                  streaming_chunk=4 * CHUNK)
    plain_stream = bytes(ZipNN(**stream).compress(raw))
    with use_mesh(make_mesh(["cpu"] * 3)):
        for p, want in zip(("per_chunk", "shared"), plain):
            assert bytes(ZipNN(**card, huffman_table=p).compress(t)) == want
            back = ZipNN(input_format="torch", engine="cuda", device="cpu").decompress(want)
            assert torch.equal(back.view(torch.int16), t.view(torch.int16))
        assert bytes(ZipNN(**stream).compress(raw)) == plain_stream
        assert bytes(ZipNN(**stream).decompress(plain_stream)) == raw
        got = list(ShardDecoder(device="cpu").decompress_iter(plain))
    assert [bytes(g) for g in got] == [t.view(torch.uint8).numpy().tobytes()] * 2


# ---------------------------------------------------------------------------
# the five stage functions against their unsharded stages
# ---------------------------------------------------------------------------

def _plan(shared: bool):
    data = _bf16ish(CHUNK * 6 + 100, seed=11)
    payload = ref_codec.compress_payload_numpy(data, 2, 1, 10, CHUNK, shared_tables=shared)
    plan = decode.build_plan(payload, 2, 1, 10, CHUNK, data.size)
    assert plan.shared == shared
    return decode.DeviceInputs(plan, "cpu")


STAGE_MESH = ["cpu", "cpu:0", "cpu"]


@pytest.mark.parametrize("shared", [False, True], ids=["k1", "k6"])
def test_sharded_decode_streams(shared):
    dv = _plan(shared)
    lo, hi = dv.batches[0]
    if shared:
        args = dv.k6_args(lo, hi)
        want = huf_shared.huf_shared_decode(*args)
        got = sharded.sharded_decode_streams(make_mesh(STAGE_MESH), *args[:6], args[7],
                                             table8=args[6])
    else:
        args = dv.k1_args(lo, hi)
        want = huf_pc.huf_pc_decode(*args)
        got = sharded.sharded_decode_streams(make_mesh(STAGE_MESH), *args[:6], args[9],
                                             cells=args[6], tlogs=args[7], tables=args[8])
    assert torch.equal(got[1], want[1])
    offs, lens = args[4].tolist(), args[5].tolist()
    for o, n in zip(offs, lens):  # bytes no stream covers are undefined
        assert torch.equal(got[0][o : o + n], want[0][o : o + n])


def _planes(seed=12, k=5, nb=2, pw=64):
    rng = np.random.default_rng(seed)
    sym = np.clip(rng.normal(120, 6, (k, nb, 4 * pw)), 0, 255).astype(np.uint8)
    return torch.from_numpy(sym.view(np.int32).copy())


@pytest.mark.parametrize("kind", ["k7", "e"])
def test_sharded_encode_streams(kind):
    planes = _planes()
    k, nb, pw = planes.shape
    seg = 4 * pw // 4
    cells = torch.arange(k * nb, dtype=torch.int64)
    streams = (cells[:, None] * pw + torch.arange(4) * (pw // 4)).reshape(-1)
    counts = np.bincount(planes.view(torch.uint8).numpy().reshape(-1), minlength=256)
    lengths = huf.build_code_lengths(counts, 8)
    vals = huf.canonical_values(lengths, int(lengths.max()))
    mesh = make_mesh(STAGE_MESH)
    if kind == "k7":
        table = torch.from_numpy(huf_enc.pack_etable(vals, lengths))
        want = huf_enc.huf_shared_encode(planes, table, seg, streams)
        got = sharded.sharded_encode_streams(mesh, planes, seg, streams, table=table)
    else:
        tables = torch.from_numpy(np.repeat(huf_enc.pack_pc_table(vals, lengths)[None],
                                            k * nb, axis=0))
        want = huf_enc.huf_pc_encode(planes, tables, seg, streams)
        got = sharded.sharded_encode_streams(mesh, planes, seg, streams, tables=tables)
    assert torch.equal(got[1], want[1])
    nbytes = ((want[1] & 0x3FFFFFFF) + 7) // 8
    for s, n in enumerate(nbytes.tolist()):  # row bytes past a stream are undefined
        assert torch.equal(got[0][s].view(torch.uint8)[:n], want[0][s].view(torch.uint8)[:n])


def test_sharded_histogram_and_split():
    planes = _planes(seed=13)
    rows = planes.reshape(-1, planes.shape[2])
    mesh = make_mesh(STAGE_MESH)
    assert torch.equal(sharded.sharded_histogram(mesh, rows), hist.hist_cells(rows))
    words = torch.from_numpy(_bf16ish(CHUNK * 7, seed=14).view(np.int32).reshape(7, -1).copy())
    assert torch.equal(sharded.sharded_split(mesh, words, 2, 10, 1),
                       transforms.split_device(words, 2, 10, 1))


@pytest.mark.parametrize("shared", [False, True], ids=["per_chunk", "shared"])
def test_sharded_combine(shared):
    dv = _plan(shared)
    lo, hi = dv.batches[0]
    name, fn, args_of = dv.decoder()
    hsym, _ = fn(*args_of(lo, hi))
    k2 = dv.k2_args(lo, hi, hsym)
    total = k2[6]
    want = combine.combine_cells(*k2, torch.empty(-(-total // 4) * 4, dtype=torch.uint8))
    got = sharded.sharded_combine(make_mesh(STAGE_MESH), *k2,
                                  torch.empty(-(-total // 4) * 4, dtype=torch.uint8))
    assert torch.equal(got[:total], want[:total])


# ---------------------------------------------------------------------------
# the multi-process encode inputs, on the three engines
# ---------------------------------------------------------------------------

def test_sampled_plane_counts_equal_reference():
    data = _bf16ish(1024 * 37 + 300, seed=21)
    for g0 in (0, 1, 5, 8, 13):
        for stride in (1, 3, 8):
            want = ref_codec.sampled_plane_counts(data, 2, 1, 10, 1024, g0, stride)
            assert np.array_equal(codec.sampled_plane_counts(data, 2, 1, 10, 1024, g0, stride),
                                  want)
            assert np.array_equal(native.sampled_counts(data, 2, 1, 10, 1024, g0, stride),
                                  want)


ENGINES = [("numpy", {}), ("native", {}), ("cuda", {"device": "cpu"})]


@pytest.mark.parametrize("engine,kw", ENGINES, ids=[e for e, _ in ENGINES])
def test_raw_planes_equal_reference(engine, kw):
    """Planes forced raw from chunk 0 (the tail too), alone and beside the
    bounded check."""
    data = _bf16ish(CHUNK * 9 + 333, seed=22)
    for raw in ([True, False], [False, True], [True, True]):
        for pct in (0, 10):
            want = ref_codec.compress_payload_numpy(data, 2, 1, 10, CHUNK, raw_planes=raw,
                                                    check_th_after_percent=pct)
            got = codec.compress_payload(data, 2, 1, 10, CHUNK, engine=engine, raw_planes=raw,
                                         check_th_after_percent=pct, **kw)
            assert bytes(got) == want, (raw, pct)


@pytest.mark.parametrize("engine,kw", ENGINES, ids=[e for e, _ in ENGINES])
def test_preset_shared_equals_reference(engine, kw):
    """A local range compressed with the tables of the global sampled
    counts (as ``tests/test_shared_sampling.py`` builds them), a rare byte
    outside the sample included."""
    chunk = 1024
    data = _bf16ish(chunk * 540 + 700, seed=23)
    data[chunk * 9 + 5] = 251  # chunk 9: not sampled at stride 8
    stride = ref_codec.shared_sample_stride(ref_codec.num_chunks_for(data.size, chunk))
    assert stride > 1
    counts = ref_codec.sampled_plane_counts(data, 2, 1, 10, chunk, 0, stride)
    ref_preset = ref_codec.shared_tables_from_counts(counts, 0.95, stride)
    preset = codec.shared_tables_from_counts(counts, 0.95, stride)
    piece = np.ascontiguousarray(data[: 200 * chunk])
    want = ref_codec.compress_payload_numpy(piece, 2, 1, 10, chunk, shared_tables=True,
                                            preset_shared=ref_preset)
    got = codec.compress_payload(piece, 2, 1, 10, chunk, engine=engine, shared_tables=True,
                                 preset_shared=preset, **kw)
    assert bytes(got) == want


# ---------------------------------------------------------------------------
# the entry module and the multichip example
# ---------------------------------------------------------------------------

def test_entry_step_is_bit_exact():
    fn, args = entry.entry(device="cpu")
    out, bits_left = fn(*args)
    assert np.array_equal(out.numpy(), entry.synth_bf16(entry.N_CHUNKS * entry.CHUNK))
    assert int(bits_left.abs().sum()) == 0


def test_dryrun_multichip_on_8_cpu_shards(capsys):
    res = entry.dryrun_multichip(8, device="cpu")
    assert res["mesh"] == {"host": 2, "chip": 4}
    assert [r["devices"] for r in res["scaling"]] == [2, 4, 8]
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_example_multichip_runs_on_the_cpu(capsys):
    """``python -m zipnn_tpu_torch.examples.example_multichip --device cpu``,
    through its ``main`` in this process."""
    from zipnn_tpu_torch.examples import example_multichip

    example_multichip.main(["--device", "cpu", "--shards", "3"])
    assert "sharded roundtrip OK" in capsys.readouterr().out
