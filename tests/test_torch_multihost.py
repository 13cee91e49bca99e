"""PyTorch port: multi-process compress and decompress of one file
(``zipnn_tpu_torch.parallel.multihost``), held against the JAX package's
one-process containers.

Mirrors ``tests/test_multihost.py``.  One pair of port-only worker
processes (gloo on 127.0.0.1; neither ``jax`` nor ``zipnn_tpu`` in their
``sys.modules``) runs every scenario in one run, in a module-scoped
fixture; each parametrised test reads one scenario's files: the
container must equal ``zipnn_tpu.ZipNN(engine="numpy", ...)``'s, computed
in this process, and must decompress back to the input.  The card's run
is in ``test_torch_cuda.py`` and ``chip_smoke.py`` phase 14.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from zipnn_tpu import ZipNN as RefZipNN
from zipnn_tpu_torch.parallel import multihost
from zipnn_tpu_torch.plugins.safetensors import SafeOpen

ROOT = Path(__file__).resolve().parent.parent

# the pair's run: every job in order, on both ranks (the collectives
# pair up by order), then the modules each rank loaded
WORKER = r"""
import json, sys
from zipnn_tpu_torch.parallel import multihost

port, rank, jobs_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
multihost.initialize(f"127.0.0.1:{port}", 2, rank)
jobs = json.load(open(jobs_path))
for job in jobs:
    if job["kind"] == "file":
        multihost.compress_file_multihost(job["src"], job["znn"], **job["kw"])
        multihost.decompress_file_multihost(job["znn"], job["back"], **job["dec_kw"])
    else:
        multihost.compress_safetensors_multihost(job["src"], job["znn"], **job["kw"])
json.dump(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "zipnn_tpu")),
          open(jobs_path + f".{rank}.modules", "w"))
"""


def _bf16(n_bytes, seed=3):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(n_bytes // 2) * 0.05).astype(np.float32)
    return ((vals.view(np.uint32) >> 16).astype("<u2")).tobytes()[:n_bytes]


def _mixed_plane_data(n_chunks, chunk, flip_at, seed=0):
    """fp16 data whose low plane flips from incompressible to compressible
    at chunk ``flip_at``: the bounded threshold check changes the bytes."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 4, n_chunks * chunk // 2, dtype=np.uint8)
    lo = np.concatenate([
        rng.integers(0, 256, flip_at * chunk // 2, dtype=np.uint8),
        rng.integers(0, 3, (n_chunks - flip_at) * chunk // 2, dtype=np.uint8),
    ])
    data = np.empty(n_chunks * chunk, np.uint8)
    data[0::2] = lo
    data[1::2] = hi
    return data.tobytes()


def _rare_byte(size, chunk, seed):
    """The 541-chunk shared case: a byte that the sampled chunks never
    hold, near the end (rank 1's range), must store its cell raw."""
    data = bytearray(_bf16(size, seed=seed))
    data[(size // chunk - 3) * chunk + 11] = 251
    return bytes(data)


CPU = {"device": "cpu"}
# name: (input bytes, the compress knobs, the decompress knobs); the reference's
# one-process container takes the compress knobs of REF_KEYS
FILES = {
    "per_chunk_numpy": (lambda: _bf16(700_000), {"compression_chunk": 128 * 1024,
                                                  "engine": "numpy"}, {"engine": "numpy"}),
    "per_chunk_native": (lambda: _bf16(700_000), {"compression_chunk": 128 * 1024,
                                                   "engine": "native"}, {"engine": "native"}),
    "per_chunk_cuda_cpu": (lambda: _bf16(700_000), {"compression_chunk": 128 * 1024,
                                                     "engine": "cuda", **CPU},
                           {"engine": "cuda", **CPU}),
    "shared_6_chunks": (lambda: _bf16(256 * 1024 * 3, seed=29),
                        {"compression_chunk": 128 * 1024, "huffman_table": "shared",
                         "engine": "cuda", **CPU}, {"engine": "native"}),
    "shared_541_chunks": (lambda: _rare_byte(1024 * 540 + 333, 1024, 29),
                          {"compression_chunk": 1024, "huffman_table": "shared",
                           "engine": "native"}, {"engine": "cuda", **CPU}),
    "bounded_check": (lambda: _mixed_plane_data(40, 4096, 30, seed=9),
                      {"bytearray_dtype": "float16", "compression_chunk": 4096,
                       "engine": "cuda", **CPU}, {"engine": "native"}),
    "streaming": (lambda: _bf16(1024 * 1024 * 3 + 12345, seed=13),
                  {"is_streaming": True, "streaming_chunk": 512 * 1024,
                   "compression_chunk": 64 * 1024, "engine": "native"},
                  {"engine": "cuda", **CPU}),
    "delta": (lambda: _bf16(700_000, seed=17), {"compression_chunk": 64 * 1024,
                                                "engine": "native"}, {"engine": "native"}),
}
REF_KEYS = ("bytearray_dtype", "compression_chunk", "huffman_table", "is_streaming",
            "streaming_chunk")


def _safetensors_file(path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(5)
    rnd = np.random.default_rng(5)
    tensors = {
        "w.attn": (torch.randn(300, 257, generator=g) * 0.05).to(torch.bfloat16),
        "w.mlp": torch.randn(123, 77, generator=g) * 0.01,
        "ids": torch.arange(1000, dtype=torch.int64),
        # incompressible bf16: the keep-raw-if-bigger rule
        "noise": torch.from_numpy(
            rnd.integers(0, 2**16, (64, 64), dtype=np.uint16).astype(np.uint16)
        ).view(torch.bfloat16),
    }
    save_file(tensors, str(path), metadata={"format": "pt"})
    return tensors


SAFETENSORS = {"st_per_chunk": {"engine": "cuda", **CPU},
               "st_shared": {"engine": "native", "huffman_table": "shared"}}


def _reap(procs):
    """Kill every worker still running (its wait timed out) and reap them
    all, so none outlives the fixture."""
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Every scenario run by one pair of worker processes: {name: dir}."""
    d = tmp_path_factory.mktemp("pair")
    jobs = []
    for name, (make, kw, dec_kw) in FILES.items():
        (d / name).mkdir()
        (d / name / "w.bin").write_bytes(make())
        kw, dec_kw = dict(kw), dict(dec_kw)
        if name == "delta":
            (d / name / "base.bin").write_bytes(_bf16(700_000, seed=18))
            kw["delta_second_path"] = dec_kw["delta_second_path"] = str(d / name / "base.bin")
        jobs.append({"kind": "file", "src": str(d / name / "w.bin"),
                     "znn": str(d / name / "w.znn"), "back": str(d / name / "back.bin"),
                     "kw": kw, "dec_kw": dec_kw})
    _safetensors_file(d / "model.safetensors")
    for name, kw in SAFETENSORS.items():
        jobs.append({"kind": "safetensors", "src": str(d / "model.safetensors"),
                     "znn": str(d / f"{name}.znn.safetensors"), "kw": kw})
    (d / "jobs.json").write_text(json.dumps(jobs))

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(port), str(rank),
                               str(d / "jobs.json")], env=env, cwd=str(d),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for rank in range(2)]
    errs = []
    deadline = time.monotonic() + 120  # the pair takes ~12 s
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(0, deadline - time.monotonic()))
            errs.append((p.returncode, err.decode()[-3000:]))
    finally:
        _reap(procs)
    for rc, err in errs:
        assert rc == 0, err
    return d


def test_workers_load_neither_jax_nor_reference(pair):
    for rank in range(2):
        assert json.loads((pair / f"jobs.json.{rank}.modules").read_text()) == []


@pytest.mark.parametrize("name", list(FILES))
def test_two_process_file_equals_one_process_reference(pair, name):
    """The pair's container equals the JAX package's one-process numpy
    container of the same knobs, and decompresses back exactly."""
    kw = FILES[name][1]
    data = (pair / name / "w.bin").read_bytes()
    ref = {k: kw[k] for k in REF_KEYS if k in kw}
    ref.setdefault("bytearray_dtype", "bfloat16")
    if name == "delta":
        golden = RefZipNN(engine="numpy", delta_compressed_type="file", **ref).compress(
            data, delta_second_data=str(pair / name / "base.bin"))
    else:
        golden = RefZipNN(engine="numpy", **ref).compress(data)
    assert (pair / name / "w.znn").read_bytes() == bytes(golden)
    assert (pair / name / "back.bin").read_bytes() == data


def test_bounded_check_changes_the_bytes():
    """The bounded-check scenario's data does trigger abandonment, so the
    pair's agreement on ``raw_planes`` is tested."""
    data = FILES["bounded_check"][0]()
    on = RefZipNN(engine="numpy", bytearray_dtype="float16", compression_chunk=4096)
    off = RefZipNN(engine="numpy", bytearray_dtype="float16", compression_chunk=4096,
                   check_th_after_percent=0)
    assert bytes(on.compress(data)) != bytes(off.compress(data))


@pytest.mark.parametrize("name", list(SAFETENSORS))
def test_two_process_safetensors_equals_one_process(pair, tmp_path, name):
    """The pair's ``.znn.safetensors`` equals a one-process run of the same
    call, keeps the incompressible tensors raw, and loads bit-exact
    through ``SafeOpen``."""
    from zipnn_tpu_torch.io.streaming import SafetensorsStreamReader

    src = pair / "model.safetensors"
    one = tmp_path / "one.znn.safetensors"
    multihost.compress_safetensors_multihost(str(src), str(one), **SAFETENSORS[name])
    two = pair / f"{name}.znn.safetensors"
    assert two.read_bytes() == one.read_bytes()
    rdr = SafetensorsStreamReader(str(two), decode_device="cpu")
    assert set(rdr.compressed) == {"w.attn", "w.mlp"}
    from safetensors.torch import load_file

    want = load_file(str(src))
    with SafeOpen(str(two), "pt", "cpu", decode_device="cpu") as f:
        for key, t in want.items():
            got = f.get_tensor(key)
            assert got.dtype == t.dtype and torch.equal(
                got.view(torch.uint8), t.view(torch.uint8)), key


def test_single_process_method_byte_matches_reference(tmp_path):
    """No process group: the header comes from ``ZipNN._make_header``, so a
    non-default method is recorded as the reference's one-process API
    records it."""
    data = _bf16(300_000, seed=19)
    src = tmp_path / "w.bin"
    src.write_bytes(data)
    multihost.compress_file_multihost(str(src), str(tmp_path / "o.znn"), method="HUFFMAN",
                                      engine="cuda", device="cpu")
    golden = RefZipNN(engine="numpy", method="HUFFMAN", bytearray_dtype="bfloat16").compress(data)
    assert (tmp_path / "o.znn").read_bytes() == bytes(golden)
    multihost.decompress_file_multihost(str(tmp_path / "o.znn"), str(tmp_path / "d.bin"),
                                        engine="native")
    assert (tmp_path / "d.bin").read_bytes() == data
    assert multihost.last_timings["wall_s"] > 0


def test_chunk_range_equals_reference():
    from zipnn_tpu.parallel.multihost import chunk_range as ref_range

    for n_chunks in (0, 1, 5, 17, 64, 541):
        for n in (1, 2, 3, 8):
            for pid in range(n):
                assert multihost.chunk_range(pid, n, n_chunks) == ref_range(pid, n, n_chunks)


def test_cuda_engine_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    src = tmp_path / "w.bin"
    src.write_bytes(_bf16(1000))
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.compress_file_multihost(str(src), str(tmp_path / "o.znn"))
