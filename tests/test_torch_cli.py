"""PyTorch port: the command-line tools (``zipnn_tpu_torch/cli``), driven
in process through each script's ``main([...])`` on the CPU (``--device
cpu``: the kernels' plain versions), held against the JAX package's CLI
functions run in process on ``engine="numpy"`` (``zipnn_tpu.cli``): every
file the port writes equals the reference's byte for byte.

Mirrors ``tests/test_cli.py`` (file round trip with ``--verification``,
``--test``, the shared profile, delta, per-tensor safetensors, the path
batch, the index rewrite), and adds: ``--engine`` takes ``cuda`` (the
default) and refuses ``tpu``; ``compress_path --max_processes 2`` in
spawned workers writes the same files; and one ``python -m`` subprocess
that loads neither ``jax`` nor ``zipnn_tpu``.  The card's run is in
``test_torch_cuda.py`` and ``chip_smoke.py`` phase 13.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zipnn_tpu.cli import compress_file as ref_compress_file
from zipnn_tpu.cli import compress_file_delta as ref_compress_file_delta
from zipnn_tpu_torch.cli import (compress_file, compress_file_delta, compress_path,
                                 compress_safetensors, decompress_file, decompress_file_delta,
                                 decompress_path, decompress_safetensors)

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def _bf16_file(path, n=300_000, seed=5):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(n // 2) * 0.05).astype(np.float32)
    data = ((vals.view(np.uint32) >> 16).astype(np.uint16)).tobytes()[:n]
    Path(path).write_bytes(data)
    return data


def _reference(tmp_path, src, fn, *args, **kw) -> bytes:
    """The .znn the JAX package's CLI function writes for a copy of
    ``src`` (engine numpy, in process)."""
    ref = tmp_path / "ref"
    ref.mkdir(exist_ok=True)
    copy = ref / Path(src).name
    shutil.copy(src, copy)
    out = fn(str(copy), *args, force=True, engine="numpy", **kw)
    return Path(out).read_bytes()


def _safetensors_parts(path):
    """(header, tensor bytes) of a safetensors file: the files are compared
    by these, since ``save_file`` writes ``__metadata__``'s keys in an order
    that varies from call to call."""
    raw = Path(path).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    return json.loads(raw[8 : 8 + n]), raw[8 + n :]


def test_compress_decompress_file_roundtrip(tmp_path, capsys):
    """16 KB chunks: the plain decoder's lockstep loop runs a chunk's
    symbols, so the two decodes stay cheap."""
    src = str(tmp_path / "weights.bin")
    data = _bf16_file(src)
    compress_file.main([src, "--force", "--verification", "--compression_chunk", "16384", *CPU])
    assert "Verification OK" in capsys.readouterr().out
    got = Path(src + ".znn").read_bytes()
    assert got == _reference(tmp_path, src, ref_compress_file.compress_file,
                             compression_chunk=16384)
    assert set(compress_file.last_timings) == {"read_s", "compress_s", "write_s"}

    os.remove(src)
    decompress_file.main([src + ".znn", "--force", "--delete", *CPU])
    assert not os.path.exists(src + ".znn")
    assert Path(src).read_bytes() == data


def test_compress_file_test_flag_writes_nothing(tmp_path):
    src = str(tmp_path / "w.bin")
    _bf16_file(src)
    compress_file.main([src, "--test", *CPU])
    assert not os.path.exists(src + ".znn")


def test_compress_file_shared_profile(tmp_path):
    src = str(tmp_path / "w.bin")
    data = _bf16_file(src)
    compress_file.main([src, "--force", "--verification", "--huffman_table", "shared",
                        "--compression_chunk", "16384", *CPU])
    assert Path(src + ".znn").read_bytes() == _reference(
        tmp_path, src, ref_compress_file.compress_file, huffman_table="shared",
        compression_chunk=16384)
    decompress_file.main([src + ".znn", "--force", *CPU])
    assert Path(src).read_bytes() == data


def test_delta_roundtrip(tmp_path):
    src = str(tmp_path / "ckpt.bin")
    base = str(tmp_path / "base.bin")
    data = _bf16_file(src, seed=1)
    _bf16_file(base, seed=2)
    compress_file_delta.main([src, base, "--force", "--verification", *CPU])
    assert Path(src + ".znn").read_bytes() == _reference(
        tmp_path, src, ref_compress_file_delta.compress_file_delta, base)
    os.remove(src)
    decompress_file_delta.main([src + ".znn", base, "--force", *CPU])
    assert Path(src).read_bytes() == data


def test_safetensors_per_tensor_roundtrip(tmp_path):
    from safetensors.torch import load_file, save_file

    from zipnn_tpu.cli.compress_safetensors import compress_safetensors_file

    src = str(tmp_path / "model.safetensors")
    t = torch.randn(300, 257, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    i = torch.arange(10)
    save_file({"w": t, "i": i}, src, metadata={"format": "pt"})
    ref = tmp_path / "ref"
    ref.mkdir()
    shutil.copy(src, ref / "model.safetensors")
    want = Path(compress_safetensors_file(str(ref / "model.safetensors"), force=True))

    compress_safetensors.main([src, "--force", *CPU])
    out = tmp_path / "model.znn.safetensors"
    assert _safetensors_parts(out) == _safetensors_parts(want)

    os.remove(src)
    decompress_safetensors.main([str(out), "--force", *CPU])
    back = load_file(src)
    assert torch.equal(back["w"].view(torch.uint16), t.view(torch.uint16))
    assert torch.equal(back["i"], i)


@pytest.mark.parametrize("workers", [1, 2])
def test_path_batch_roundtrip(tmp_path, workers):
    """The batch over 3 files, in this process or (``--max_processes 2``,
    engine native) in spawned workers: each .znn equals the one the
    reference's ``compress_file`` writes, and every file comes back."""
    d = tmp_path / "ckpts"
    d.mkdir()
    datas = {}
    for i in range(3):
        p = str(d / f"shard{i}.bin")
        datas[p] = _bf16_file(p, n=50_000, seed=i)
    wants = {p: _reference(tmp_path, p, ref_compress_file.compress_file) for p in datas}
    engine = ["--engine", "native"] if workers > 1 else CPU
    compress_path.main(["bin", "--path", str(d), "--force", "--max_processes", str(workers),
                        *engine])
    for p in datas:
        assert Path(p + ".znn").read_bytes() == wants[p]
        os.remove(p)
    decompress_path.main(["--path", str(d), "--force", "--delete", *CPU])
    for p, data in datas.items():
        assert Path(p).read_bytes() == data
        assert not os.path.exists(p + ".znn")


def test_index_json_rewrite(tmp_path):
    d = tmp_path / "m"
    d.mkdir()
    idx = {"weight_map": {"a": "model-00001.safetensors"}}
    (d / "model.safetensors.index.json").write_text(json.dumps(idx))
    compress_path.rewrite_index_json(str(d), add_suffix=True)
    got = json.loads((d / "model.safetensors.index.json").read_text())
    assert got["weight_map"]["a"] == "model-00001.safetensors.znn"
    compress_path.rewrite_index_json(str(d), add_suffix=False)
    got = json.loads((d / "model.safetensors.index.json").read_text())
    assert got["weight_map"]["a"] == "model-00001.safetensors"


@pytest.mark.parametrize("script", [compress_file, decompress_file, compress_file_delta,
                                    decompress_file_delta, compress_path, decompress_path])
def test_engine_flag(script, capsys):
    """``--engine`` lists cuda as its default and refuses the reference's
    ``tpu``."""
    with pytest.raises(SystemExit):
        script.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "--engine {auto,numpy,native,cuda}" in text and "default cuda" in text
    with pytest.raises(SystemExit) as exc:
        script.main(["x", "y", "--engine", "tpu"])
    assert exc.value.code == 2
    assert "invalid choice: 'tpu'" in capsys.readouterr().err


def test_module_run_loads_neither_jax_nor_reference(tmp_path):
    """``python -m zipnn_tpu_torch.cli.compress_file`` writes the same file
    and imports no module of ``jax`` or ``zipnn_tpu`` (``-X importtime``
    lists every module the interpreter loads)."""
    src = str(tmp_path / "w.bin")
    _bf16_file(src, n=20_000)
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "zipnn_tpu_torch.cli.compress_file", src,
         "--force", *CPU], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = [ln.rsplit("|", 1)[-1].strip() for ln in res.stderr.splitlines()
              if ln.startswith("import time:")]
    assert "zipnn_tpu_torch.cli.compress_file" in loaded or "zipnn_tpu_torch.zipnn" in loaded
    bad = [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "zipnn_tpu")]
    assert not bad, bad
    assert Path(src + ".znn").read_bytes() == _reference(tmp_path, src,
                                                         ref_compress_file.compress_file)
