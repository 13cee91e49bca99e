"""CPU tests of the port's benchmark: what it may import, how cells find
their files, the configurations' totals, the byte arithmetic, the
reference encoder, and a run of each mix at a tiny size."""
from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import harness, model
from port_bench.metrics import _yardstick as ys
from port_bench.reference import encoder

from .conftest import REPO, run_cell

PB = REPO / "port_bench"


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_imports_no_jax_and_no_reference_package(path):
    """Top-level names compared whole: ``zipnn_tpu_torch`` is not
    ``zipnn_tpu``."""
    names = imported_top_names(path)
    assert not names & {"jax", "jaxlib", "flax", "zipnn_tpu"}
    if "reference" in path.relative_to(PB).parts:
        assert "zipnn_tpu_torch" not in names
    if "tests" not in path.relative_to(PB).parts and path.name != "system.py":
        assert "zipnn_tpu_torch" not in names  # the program enters through system.py only


def test_banned_modules_compares_whole_names(monkeypatch):
    import sys  # noqa: PLC0415

    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "zipnn_tpu.codec", object())
    assert harness.banned_modules() == ["zipnn_tpu.codec"]


def test_every_cell_resolves():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        spec = harness.resolve(bench, cell["name"])
        for key in ("config_file", "mix_file", "driver_file"):
            assert spec[key].is_file(), (cell["name"], key)
        assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        moved = {m["name"] for m in spec["end_to_end"]}
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert m["file"].is_file(), m["name"]
            assert callable(harness._load(m["file"], "m").read)
        for m in spec["per_layer"]:
            assert m["moves"] in moved, (cell["name"], m["name"])


def test_new_files_are_found_without_edits(tmp_path):
    """A configuration, a mix and a per-layer metric added as new files in
    a copy, with new entries in its BENCHMARK.json, resolve by name."""
    shutil.copytree(PB, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    pb = tmp_path / "port_bench"
    shutil.copy(pb / "configs" / "mistral-7b-v0.1.json", pb / "configs" / "new-model.json")
    mix = json.loads((pb / "traffic" / "resident.json").read_text())
    (pb / "traffic" / "long_resident.json").write_text(json.dumps(dict(mix, trace_cycles=5)))
    (pb / "metrics" / "new_metric.resident.py").write_text(
        "def read(run):\n    return run['window']['requests']\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="new-model",
                                 file="port_bench/configs/new-model.json"))
    bench["workloads"].append({"name": "new.long_resident", "config": "new-model",
                               "traffic": "long_resident", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("new.long_resident")
    bench["per_layer"].append({"name": "new_metric.resident", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "serving",
                               "moves": "resident_decode_GBps",
                               "workloads": ["new.long_resident"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.resolve(bench, "new.long_resident", tmp_path)
    assert spec["config_file"] == pb / "configs" / "new-model.json"
    assert json.loads(spec["mix_file"].read_text())["trace_cycles"] == 5
    assert spec["driver_file"] == pb / "drivers" / "resident.py"
    new = [m for m in spec["per_layer"] if m["name"] == "new_metric.resident"][0]
    assert harness._load(new["file"], "m").read({"window": {"requests": 3}}) == 3
    assert len(model.load(spec["config_file"]).tensors) == 291
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("name", ["mistral-7b-v0.1", "deepseek-v2-lite"])
def test_config_totals_and_widths(name):
    cfg = json.loads((PB / "configs" / f"{name}.json").read_text())
    m = model.load(PB / "configs" / f"{name}.json")
    st = cfg["stated"]
    assert len(m.tensors) == st["tensors"] and m.nbytes == st["bytes"]
    assert len(m.units) == cfg["num_hidden_layers"] + 1
    block = m.units[-2]
    assert len(block) == st["block_tensors"]
    assert sum(m.tensor_bytes(i) for i in block) == st["block_bytes"]
    shapes = {t.name: t.shape for t in m.tensors}
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    assert shapes["model.embed_tokens.weight"] == (v, h) == shapes["lm_head.weight"]
    last = cfg["num_hidden_layers"] - 1
    pre = f"model.layers.{last}."
    if name == "mistral-7b-v0.1":
        kv = h // cfg["num_attention_heads"] * cfg["num_key_value_heads"]
        assert shapes[pre + "self_attn.k_proj.weight"] == (kv, h)
        assert shapes[pre + "mlp.down_proj.weight"] == (h, cfg["intermediate_size"])
    else:
        heads, nope, rope = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                             cfg["qk_rope_head_dim"])
        assert cfg["q_lora_rank"] is None
        assert shapes[pre + "self_attn.q_proj.weight"] == (heads * (nope + rope), h)
        assert shapes[pre + "self_attn.kv_a_proj_with_mqa.weight"] == (cfg["kv_lora_rank"] + rope, h)
        assert shapes[pre + "self_attn.kv_b_proj.weight"] == (
            heads * (nope + cfg["v_head_dim"]), cfg["kv_lora_rank"])
        e = cfg["moe_intermediate_size"]
        assert shapes[pre + f"mlp.experts.{cfg['n_routed_experts'] - 1}.up_proj.weight"] == (e, h)
        assert shapes[pre + "mlp.shared_experts.up_proj.weight"] == (cfg["n_shared_experts"] * e, h)
        assert shapes[pre + "mlp.gate.weight"] == (cfg["n_routed_experts"], h)
        assert shapes["model.layers.0.mlp.up_proj.weight"] == (cfg["intermediate_size"], h)
        assert cfg["reduced"]["num_hidden_layers"]["from"] == 27


def test_byte_arithmetic_on_a_port_container():
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415

    t = (torch.randn(300, 700, generator=torch.Generator().manual_seed(3)) * 0.05).to(torch.bfloat16)
    c = ZipNN(input_format="torch", engine="cuda", device="cpu").compress(t)
    head, payload, original = ys.container_sizes(c)
    assert head == 32 + len(encoder.pack_shape(t.shape)) == 32 + 7
    assert original == t.numel() * 2 and head + payload == len(c)
    assert ys.union([(0, 2), (1, 3), (5, 6)], 0.5, 5.5) == 3.0
    assert ys.gaps([(1, 2), (1.5, 3)], 0, 4) == [(0, 1), (3, 4)]
    assert ys.roofline_pct(3.35e12, 2.0) == 50.0 and ys.roofline_pct(1, 0) is None


@pytest.mark.parametrize("shape,dtype,scale", [
    ((700, 300), torch.bfloat16, 0.05), ((131075,), torch.bfloat16, 0.05),
    ((64, 2048), torch.bfloat16, 0.0), ((3,), torch.bfloat16, 1.0),
    ((1024, 300), torch.float32, 0.05), ((1024, 300), torch.float16, 0.05),
    ((2048, 1024), torch.bfloat16, 40.0)])
def test_reference_encoder_equals_golden_encoder(shape, dtype, scale):
    from zipnn_tpu_torch import ZipNN  # noqa: PLC0415

    t = (torch.randn(shape, generator=torch.Generator().manual_seed(11)) * scale).to(dtype)
    want = ZipNN(input_format="torch", engine="numpy").compress(t)
    got = encoder.encode(t.reshape(-1).view(torch.uint8), t.shape, model.DTYPE_NAMES[dtype])
    assert got == want


def test_weights_repeat_from_the_seed():
    m = model.load(PB / "configs" / "mistral-7b-v0.1.json")
    m.tensors = m.tensors[:1]
    m.tensors[0].shape = (64, 64)
    a, b = model.weights(m, 2**31 + 5, "cpu"), model.weights(m, 2**31 + 5, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, model.weights(m, 2**31 + 6, "cpu"))
    assert abs(float(a.float().std()) - model.STD) < 0.01


def test_a_run_on_the_cpu(tiny_root, capsys):
    rc, res = run_cell(tiny_root, "tiny.resident", capsys=capsys)
    assert rc == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert res["metrics"]["resident_block_p95_ms"]["value"] > 0
    assert list(res)[-1] == "checks" and all(c["limit"] == 0 for c in res["checks"].values())
    assert res["checks"]["outputs_reused"]["value"] == 0


def test_a_traced_run_on_the_cpu(tiny_root, capsys):
    rc, res = run_cell(tiny_root, "tiny.resident", trace=1, capsys=capsys)
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) >= {"launches_per_GB.resident", "idle_share.resident"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_block_p95_is_the_tail_of_every_request():
    p95 = harness._load(PB / "metrics" / "resident_block_p95_ms.py", "m")
    took = [0.001] * 95 + [0.1] * 5
    assert p95.read({"window": {"request_s": took}}) == pytest.approx(1e3 * (0.001 + 0.05 * 0.099))
    assert p95.read({"window": {"request_s": [0.002]}}) is None


def test_profile_comes_from_the_configuration(tmp_path):
    cfg = json.loads((PB / "configs" / "mistral-7b-v0.1.json").read_text())
    m = model.load(PB / "configs" / "mistral-7b-v0.1.json")
    assert (m.chunk, m.huffman_table) == (cfg["container"]["chunk"], "per_chunk")
    cfg["container"]["huffman_table"] = "shared"
    (tmp_path / "shared.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="per_chunk"):
        model.load(tmp_path / "shared.json")


def test_no_result_without_a_card(tiny_root, capsys):
    from port_bench import harness as h  # noqa: PLC0415

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = h.main(["--workload", "tiny.resident", "--seed", "1", "--seconds", "1"], 0.0, root=tiny_root)
    assert rc != 0 and capsys.readouterr().out == ""


def test_sample_holds_largest_and_smallest():
    import random  # noqa: PLC0415

    from port_bench import loop  # noqa: PLC0415

    m = model.load(PB / "configs" / "deepseek-v2-lite.json")
    for seed in range(5):
        idx = loop.sample(m, random.Random(seed), 1e9)
        sizes = [m.tensors[i].numel for i in idx]
        assert max(sizes) == max(t.numel for t in m.tensors)
        assert min(sizes) == min(t.numel for t in m.tensors)
        assert sum(m.tensor_bytes(i) for i in idx) <= 1e9
    assert np.all(np.asarray(idx) >= 0)
