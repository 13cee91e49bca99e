"""PyTorch port: the examples (``zipnn_tpu_torch/examples/``) on the CPU, the
port's safetensors layout held against the ``safetensors`` package, and
the packaging of the port.

* each example's ``main([..., "--device", "cpu"])`` runs in this process at
  a small size and prints its success line; the containers of
  ``simple_example_byte``, ``simple_example_device``, ``example_delta`` and
  ``example_lossy`` equal, byte for byte, the JAX package's numpy engine's
  for the same inputs (built here with numpy from the example's seed) and
  arguments; ``example_hf_model --demo`` runs where transformers imports;
  ``example_vllm`` says vLLM is missing and returns; every example refuses
  ``--device cuda`` with no card;
* ``io.safetensors_layout`` writes ``safetensors.torch.save_file``'s file
  byte for byte over every dtype it maps, and reads what the package's
  ``safe_open`` reads; with the package hidden, ``save_pytree``, both
  safetensors CLIs and ``SafeOpen`` give the same files and tensors as with
  it, and the JAX package's ``load_pytree`` reads the port's file;
* ``pyproject.toml`` ships every file of ``zipnn_tpu_torch/csrc/`` and names
  each of the port's CLI modules once.
"""
import fnmatch
import importlib
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

import zipnn_tpu
from zipnn_tpu_torch.io import safetensors_layout as layout

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _main(name: str, argv):
    return importlib.import_module(f"zipnn_tpu_torch.examples.{name}").main([*argv, *CPU])


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

# name: (small-size arguments, success line)
RUNS = {
    "simple_example_torch": (["--rows", "64"], "torch roundtrip OK"),
    "example_checkpoint": (["--size-mb", "1"], "bit-exact"),
    "example_shard_serving": (["--shard-mib", "0.125"], "via stacked bundles: bit-exact"),
    "example_fused_serving": (["--rows", "128"], "pytree checkpoint roundtrip OK"),
    "example_safetensors": ([], "safetensors per-tensor roundtrip OK, 2 tensors compressed"),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_example_runs(name, capsys):
    argv, line = RUNS[name]
    _main(name, argv)
    assert line in capsys.readouterr().out


def _byte_reference():
    n = 150_000  # one full 256 KB chunk and a tail
    vals = (np.random.default_rng(0).standard_normal(n) * 0.05).astype(np.float32)
    data = ((vals.view(np.uint32) >> 16).astype(np.uint16)).tobytes()
    z = zipnn_tpu.ZipNN(engine="numpy", input_format="byte", bytearray_dtype="bfloat16")
    return ["--values", str(n)], {"container": bytes(z.compress(data))}


def _device_reference():
    x = _bf16(np.random.default_rng(0).standard_normal((512, 513))) * 0.05
    z = zipnn_tpu.ZipNN(engine="numpy", input_format="torch", huffman_table="shared",
                        compression_chunk=16384)
    return [], {"container": bytes(z.compress(x))}


def _delta_reference():
    n = 100_000
    base = (np.random.default_rng(0).standard_normal(n) * 0.05).astype(np.float32)
    ft = base.copy()
    ft[:1000] += 1e-3
    delta = zipnn_tpu.ZipNN(engine="numpy", delta_compressed_type="byte").compress(
        ft.tobytes(), delta_second_data=base.tobytes())
    plain = zipnn_tpu.ZipNN(engine="numpy").compress(ft.tobytes())
    return ["--values", str(n)], {"container": bytes(delta), "plain": bytes(plain)}


def _lossy_reference():
    t = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 512)).astype(np.float32))
    lossy = zipnn_tpu.ZipNN(engine="numpy", input_format="torch",
                            lossy_compressed_type="integer",
                            lossy_compressed_factor=16).compress(t)
    lossless = zipnn_tpu.ZipNN(engine="numpy", input_format="torch").compress(t)
    return [], {"container": bytes(lossy), "lossless": bytes(lossless)}


REFERENCES = {
    "simple_example_byte": (_byte_reference, "byte roundtrip OK"),
    "simple_example_device": (_device_reference, "device tensor roundtrip OK"),
    "example_delta": (_delta_reference, "delta roundtrip OK"),
    "example_lossy": (_lossy_reference, "lossy roundtrip OK"),
}


@pytest.mark.parametrize("name", list(REFERENCES))
def test_example_container_equals_jax_numpy_engine(name, capsys):
    """The example's containers (tolerance 0) are the JAX package's numpy
    engine's for the same seeded inputs, built here."""
    reference, line = REFERENCES[name]
    argv, want = reference()
    got = _main(name, argv)
    assert line in capsys.readouterr().out
    assert {k: got[k] for k in want} == want


def test_example_hf_model_demo(monkeypatch, capsys):
    monkeypatch.setenv("USE_TF", "0")
    pytest.importorskip("transformers")
    from transformers import modeling_utils

    saved = (modeling_utils.load_state_dict, modeling_utils.PreTrainedModel.from_pretrained,
             modeling_utils.cached_file)
    try:
        _main("example_hf_model", ["--demo", "--n-embd", "64", "--vocab-size", "1000"])
    finally:
        (modeling_utils.load_state_dict, modeling_utils.PreTrainedModel.from_pretrained,
         modeling_utils.cached_file) = saved
    assert "hf roundtrip OK: 28 tensors" in capsys.readouterr().out


def test_example_vllm_without_vllm(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "vllm", None)  # find_spec: not installed
    assert _main("example_vllm", []) == {"ran": False}
    assert "vllm is not installed" in capsys.readouterr().out


CARD_ARGS = {**{k: [] for k in (*RUNS, *REFERENCES)}, "example_vllm": []}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", sorted(CARD_ARGS))
def test_example_refuses_cuda_without_a_card(name):
    mod = importlib.import_module(f"zipnn_tpu_torch.examples.{name}")
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([*CARD_ARGS[name], "--device", "cuda"])


# ---------------------------------------------------------------------------
# H1: the safetensors layout with no package
# ---------------------------------------------------------------------------

def _every_dtype():
    """Three tensors of each dtype of the map (a scalar, an empty one and a
    matrix), named so that name order and insertion order differ."""
    g = torch.Generator().manual_seed(11)
    out = {}
    for name, dtype in reversed(layout.DTYPES.items()):
        size = torch.empty(0, dtype=dtype).element_size()
        raw = torch.randint(0, 256, (7, 5 * size), generator=g, dtype=torch.uint8)
        if dtype == torch.bool:
            raw = raw & 1
        out[f"z.{name}"] = raw.view(dtype)
        out[f"a.{name}"] = raw[0, :size].clone().view(dtype).reshape(())
        out[f"m.{name}"] = torch.empty(0, 3, dtype=dtype)
    return out


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}, {}])
def test_layout_write_equals_save_file(tmp_path, metadata):
    tensors = _every_dtype()
    save_file(tensors, tmp_path / "pkg.safetensors", metadata=metadata)
    layout.write(tmp_path / "port.safetensors", tensors, metadata)
    want = (tmp_path / "pkg.safetensors").read_bytes()
    assert (tmp_path / "port.safetensors").read_bytes() == want
    assert layout.to_bytes(tensors, metadata) == want


def test_layout_write_several_metadata_keys(tmp_path):
    """The package writes two or more metadata keys in no fixed order: the
    headers equal as JSON, the data byte for byte."""
    tensors = _every_dtype()
    md = {"format": "pt", "znn_compressed_vectors": "{}", "zz": "ü\n"}
    save_file(tensors, tmp_path / "pkg.safetensors", metadata=md)
    layout.write(tmp_path / "port.safetensors", tensors, md)
    pkg = (tmp_path / "pkg.safetensors").read_bytes()
    port = (tmp_path / "port.safetensors").read_bytes()
    (hp, sp), (ho, so) = layout.read_header(pkg), layout.read_header(port)
    assert sp == so and hp == ho and pkg[sp:] == port[so:]


def test_read_header_equals_safe_open(tmp_path):
    tensors = _every_dtype()
    path = tmp_path / "pkg.safetensors"
    save_file(tensors, path, metadata={"format": "pt"})
    header, start = layout.read_header(path)
    assert layout.read_header(path.read_bytes()) == (header, start)
    got, md = layout.read(path)
    with safe_open(str(path), "pt") as f:
        assert sorted(got) == f.keys()
        assert header.pop(layout.METADATA) == md == f.metadata()
        for name in f.keys():
            want = f.get_tensor(name)
            assert got[name].dtype == want.dtype and got[name].shape == want.shape
            assert (layout.as_tensor(layout.read_range(path, header[name], start), header[name])
                    .reshape(-1).view(torch.uint8).tolist()
                    == want.reshape(-1).view(torch.uint8).tolist()), name


def _hide_safetensors(monkeypatch):
    for mod in [m for m in sys.modules if m == "safetensors" or m.startswith("safetensors.")]:
        monkeypatch.setitem(sys.modules, mod, None)


def _h1_outputs(d: Path) -> dict:
    """Files and tensors of every path H1 frees from the package, in ``d``."""
    from zipnn_tpu_torch.cli.compress_safetensors import compress_safetensors_file
    from zipnn_tpu_torch.cli.decompress_safetensors import decompress_safetensors_file
    from zipnn_tpu_torch.io.pytree import save_pytree
    from zipnn_tpu_torch.plugins.safetensors import SafeOpen

    rng = np.random.default_rng(3)
    tree = {"dense": {"kernel": _bf16(rng.standard_normal((96, 80)) * 0.05),
                      "bias": torch.zeros(80)},
            "steps": torch.arange(5)}
    save_pytree(str(d / "tree.znn.safetensors"), tree, device="cpu")
    src = d / "m.safetensors"
    layout.write(src, {"w": _bf16(rng.standard_normal((300, 257)) * 0.05),
                       "f": torch.from_numpy(rng.standard_normal((70, 33)).astype(np.float32)),
                       "i": torch.arange(10)}, {"format": "pt"})
    comp = compress_safetensors_file(str(src), force=True, device="cpu")
    (d / "m.safetensors").unlink()
    back = decompress_safetensors_file(comp, force=True, device="cpu")
    with SafeOpen(comp, "pt", decode_device="cpu") as f:
        one = {n: f.get_tensor(n) for n in f.keys()}
        bulk = f.get_tensors()
        keys, md = f.keys(), f.metadata()
    out = {p.name: p.read_bytes() for p in (d / "tree.znn.safetensors", Path(comp), Path(back))}
    return {**out, "keys": keys, "metadata": md,
            **{f"one.{n}": t.view(torch.uint8) for n, t in one.items()},
            **{f"bulk.{n}": t.view(torch.uint8) for n, t in bulk.items()}}


def test_safetensors_paths_need_no_package(tmp_path, monkeypatch):
    from zipnn_tpu.io import load_pytree as jax_load_pytree
    from zipnn_tpu_torch.plugins.safetensors import SafeOpen

    (tmp_path / "with").mkdir()
    (tmp_path / "without").mkdir()
    want = _h1_outputs(tmp_path / "with")
    _hide_safetensors(monkeypatch)
    got = _h1_outputs(tmp_path / "without")
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    with SafeOpen(str(tmp_path / "without" / "m.znn.safetensors"), "pt",
                  decode_device="cpu") as f:
        with pytest.raises(ImportError, match="safetensors"):
            f.get_slice("i")
    monkeypatch.undo()

    tree = jax_load_pytree(str(tmp_path / "without" / "tree.znn.safetensors"))
    kernel = np.asarray(tree["dense"]["kernel"]).view(np.uint16)
    rng = np.random.default_rng(3)
    assert np.array_equal(kernel, _bf16(rng.standard_normal((96, 80)) * 0.05)
                          .view(torch.uint16).numpy())
    assert np.array_equal(np.asarray(tree["steps"]), np.arange(5))


# ---------------------------------------------------------------------------
# packaging
# ---------------------------------------------------------------------------

def test_pyproject_ships_the_sources_and_names_the_cli():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["zipnn_tpu_torch"]
    pkg = ROOT / "zipnn_tpu_torch"
    for f in sorted((pkg / "csrc").iterdir()):
        rel = f.relative_to(pkg).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} is not package data"
    targets = [v for v in cfg["project"]["scripts"].values()
               if v.startswith("zipnn_tpu_torch.cli.")]
    modules = sorted(p.stem for p in (pkg / "cli").glob("*.py") if p.stem != "__init__")
    assert sorted(t.split(":")[0].rsplit(".", 1)[1] for t in targets) == modules
    for t in targets:
        mod, fn = t.split(":")
        assert fn == "main" and callable(getattr(importlib.import_module(mod), fn)), t


def test_examples_fetch_nothing():
    """No example names a URL or the Hub model the JAX package's vLLM
    example fetches."""
    for f in sorted((ROOT / "zipnn_tpu_torch" / "examples").glob("*.py")):
        text = f.read_text()
        assert "http" not in text and "gpt2-ZipNN" not in text, f.name
