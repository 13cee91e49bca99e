"""PyTorch port: the safetensors and Hugging Face plugins on the CPU, held
against the JAX package's.

* the ``znn_compressed_vectors`` schema and ``compress_tensor`` /
  ``decompress_tensor``: the port's stored bytes equal the JAX package's,
  and each decodes the other's;
* ``SafeOpen`` (``get_tensor``, ``get_tensors`` through ``ShardDecoder``,
  the numpy frontend, ``get_slice``) on files either package writes, the
  decode on ``decode_device`` and the result on the caller's ``device``;
  the flax frontend refused;
* ``zipnn_safetensors()`` installs ``SafeOpen`` bound to its decode device;
* ``zipnn_hf()``: ``load_state_dict`` of a whole-file ``.safetensors.znn``
  and ``from_pretrained`` of a tiny in-test Llama whose shard the JAX
  package compressed as a streaming container.

Everything decodes with ``decode_device="cpu"`` (the kernels' plain
versions).
"""
import json
import os

import numpy as np
import pytest
import torch
from safetensors.torch import save_file

import zipnn_tpu
from zipnn_tpu.plugins import safetensors as ref_st
from zipnn_tpu_torch.plugins import safetensors as port_st
from zipnn_tpu_torch.plugins.hf import replace_in_file


def _tensors(seed=7):
    g = torch.Generator().manual_seed(seed)
    return {
        "w.bf16": torch.randn(300, 257, generator=g).to(torch.bfloat16),
        "w.fp32": torch.randn(333, 77, generator=g),
        "w.fp16": torch.randn(64, 129, generator=g).to(torch.float16),
        "b.int64": torch.arange(100, dtype=torch.int64),
    }


def _write(path, plugin, **kw):
    """A ``.znn.safetensors`` file written with ``plugin``'s
    ``compress_tensor``; returns the originals and the metadata infos."""
    tensors = _tensors()
    out, infos = {}, {}
    for name, t in tensors.items():
        res = plugin.compress_tensor(t, **kw) if t.is_floating_point() else None
        if res is None:
            out[name] = t
        else:
            out[name], infos[name] = res
    md = {"format": "pt"}
    plugin.set_compressed_tensors_metadata(infos, md)
    save_file(out, path, metadata=md)
    return tensors, infos


def _same(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def test_metadata_schema_and_tensor_codecs():
    md = {"format": "pt"}
    infos = {"a": {"dtype": "bfloat16", "shape": "[2, 3]"}}
    port_st.set_compressed_tensors_metadata(infos, md)
    assert json.loads(md[port_st.METADATA_KEY]) == infos
    assert port_st.get_compressed_tensors_metadata(md) == infos
    assert port_st.get_compressed_tensors_metadata(None) == {}
    for t in _tensors().values():
        if not t.is_floating_point():
            continue
        blob, info = port_st.compress_tensor(t, device="cpu")
        ref_blob, ref_info = ref_st.compress_tensor(t)
        assert torch.equal(blob, ref_blob) and info == ref_info
        assert _same(port_st.decompress_tensor(ref_blob, device="cpu"), t)
        assert _same(ref_st.decompress_tensor(blob), t)
    noise = torch.randint(-2**15, 2**15, (64, 64), dtype=torch.int16).view(torch.bfloat16)
    assert port_st.compress_tensor(noise, device="cpu") is None


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_safe_open_reads_either_package(tmp_path, writer):
    path = str(tmp_path / "model.znn.safetensors")
    if writer == "port":
        tensors, infos = _write(path, port_st, device="cpu")
        with ref_st.SafeOpen(path, framework="pt") as f:
            assert all(_same(f.get_tensor(n), t) for n, t in tensors.items())
    else:
        tensors, infos = _write(path, ref_st)
    with port_st.SafeOpen(path, "pt", decode_device="cpu") as f:
        assert set(f.compressed_tensors_metadata) == set(infos) == {"w.bf16", "w.fp32", "w.fp16"}
        bulk = f.get_tensors()
        for name, want in tensors.items():
            assert _same(f.get_tensor(name), want) and _same(bulk[name], want), name
        assert f.get_tensors(["w.fp32"]).keys() == {"w.fp32"}
        assert f.get_slice("b.int64") is not None
        with pytest.raises(NotImplementedError):
            f.get_slice("w.bf16")
    with port_st.SafeOpen(path, "np", decode_device="cpu") as f:
        got = f.get_tensor("w.fp32")
        assert isinstance(got, np.ndarray) and np.array_equal(got, tensors["w.fp32"].numpy())
    with pytest.raises(ValueError, match="no JAX arrays"):
        port_st.SafeOpen(path, "flax", decode_device="cpu")


def test_zipnn_safetensors_installs_safe_open_with_its_decode_device(tmp_path):
    import safetensors.numpy as st_np
    import safetensors.torch as st

    from zipnn_tpu_torch import zipnn_safetensors

    path = str(tmp_path / "model.znn.safetensors")
    tensors, _ = _write(path, ref_st)
    originals = st.safe_open, st_np.safe_open
    try:
        zipnn_safetensors(decode_device="cpu")
        zipnn_safetensors(decode_device="cpu")  # idempotent
        assert st.safe_open is st_np.safe_open
        assert st.safe_open.func is port_st.SafeOpen
        assert st.safe_open.keywords == {"decode_device": "cpu"}
        with st.safe_open(path, framework="pt", device="cpu") as f:
            assert _same(f.get_tensor("w.bf16"), tensors["w.bf16"])
    finally:
        st.safe_open, st_np.safe_open = originals


def test_hf_replace_in_file(tmp_path):
    p = str(tmp_path / "index.json")
    with open(p, "w") as f:
        f.write('{"weight_map": {"a": "model.safetensors.znn"}}')
    replace_in_file(p, "model.safetensors.znn", "model.safetensors")
    with open(p) as f:
        assert ".znn" not in f.read()


@pytest.fixture
def hf_restored(monkeypatch):
    """transformers' functions that ``zipnn_hf`` patches, put back after.
    transformers is imported without TensorFlow, which these tests do not
    use and which takes seconds to import."""
    monkeypatch.setenv("USE_TF", "0")
    from transformers import modeling_utils

    saved = (modeling_utils.load_state_dict, modeling_utils.PreTrainedModel.from_pretrained,
             modeling_utils.cached_file)
    yield modeling_utils
    (modeling_utils.load_state_dict, modeling_utils.PreTrainedModel.from_pretrained,
     modeling_utils.cached_file) = saved


def test_hf_from_pretrained_tiny_llama(tmp_path, hf_restored):
    """A local tiny Llama whose safetensors shard only exists as a
    streaming ``.znn`` (written by the JAX package) loads through the
    patched ``from_pretrained`` with ``replace_local_file=True``; the
    state dict equals the saved one."""
    from transformers import LlamaConfig, LlamaForCausalLM

    from zipnn_tpu_torch import zipnn_hf

    torch.manual_seed(0)
    cfg = LlamaConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1, vocab_size=128,
                      max_position_embeddings=64)
    model = LlamaForCausalLM(cfg).to(torch.bfloat16)
    d = str(tmp_path / "tiny-llama")
    model.save_pretrained(d, safe_serialization=True)
    plain = os.path.join(d, "model.safetensors")
    with open(plain, "rb") as f:
        raw = f.read()
    with open(plain + ".znn", "wb") as f:
        f.write(bytes(zipnn_tpu.ZipNN(is_streaming=True, streaming_chunk=1 << 16,
                                      engine="numpy").compress(raw)))
    os.remove(plain)
    zipnn_hf(replace_local_file=True, decode_device="cpu")
    loaded = LlamaForCausalLM.from_pretrained(d, torch_dtype=torch.bfloat16)
    assert os.path.exists(plain) and not os.path.exists(plain + ".znn")
    with open(plain, "rb") as f:
        assert f.read() == raw
    want, got = model.state_dict(), loaded.state_dict()
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_hf_load_state_dict_decodes_znn(tmp_path, hf_restored):
    from zipnn_tpu_torch import ZipNN, zipnn_hf

    zipnn_hf(decode_device="cpu")
    plain = str(tmp_path / "model.safetensors")
    t = torch.randn(64, 65).to(torch.bfloat16)
    save_file({"w": t}, plain, metadata={"format": "pt"})
    with open(plain, "rb") as f:
        raw = f.read()
    with open(plain + ".znn", "wb") as f:
        f.write(ZipNN(is_streaming=True, streaming_chunk=4096, device="cpu").compress(raw))
    sd = hf_restored.load_state_dict(plain + ".znn")
    assert _same(sd["w"], t)
