"""CPU tests of the benchmark's fp32 hybrid configuration
(``configs/nemotron-3-nano-30b-a3b-fp32-ep16.json``: NVIDIA Nemotron-3
Nano 30B-A3B's fp32 master weights, one chip's share under 16-way expert
parallelism) and of ``metrics/combine_roofline.resident.py``:

* the configuration's totals and stated block sizes; its 53 units follow
  ``hybrid_override_pattern`` letter by letter, then the head and tail;
  every matrix has the published widths;
* the share: the 16 chips' expert tensors partition the uncut layer's
  128 experts, the replicated tensors counted once with them make up the
  whole layer, and the configuration's MoE block is share 0;
* a traced CPU run of a tiny fp32 hybrid checkpoint (one block of each
  kind) through the harness;
* the reader on synthetic traces.
"""
from __future__ import annotations

import json
import shutil

import pytest

from port_bench import harness, model

from .conftest import REPO, run_cell

PB = REPO / "port_bench"
NAME = "nemotron-3-nano-30b-a3b-fp32-ep16"
CFG_FILE = PB / "configs" / f"{NAME}.json"
READER = PB / "metrics" / "combine_roofline.resident.py"
KIND_OF = {"in_proj": "M", "gate": "E", "q_proj": "*"}  # a mixer tensor that names its kind


def _cfg():
    return json.loads(CFG_FILE.read_text())


def _kind(mdl, unit):
    names = {mdl.tensors[i].name.split(".mixer.")[-1].split(".")[0] for i in unit}
    kinds = {KIND_OF[n] for n in names if n in KIND_OF}
    assert len(kinds) == 1, names
    return kinds.pop()


def _moe_layer(cfg, n_experts, experts):
    """(name, shape) of a MoE layer's tensors holding ``experts`` of the
    ``n_experts`` the router scores, in checkpoint order."""
    h, e = cfg["hidden_size"], cfg["moe_intermediate_size"]
    sh = cfg["moe_shared_expert_intermediate_size"] * cfg["n_shared_experts"]
    x = "backbone.layers.{i}.mixer."
    out = [("backbone.layers.{i}.norm.weight", (h,)), (x + "gate.weight", (n_experts, h)),
           (x + "gate.e_score_correction_bias", (n_experts,))]
    for k in experts:
        out += [(x + f"experts.{k}.up_proj.weight", (e, h)),
                (x + f"experts.{k}.down_proj.weight", (h, e))]
    return out + [(x + "shared_experts.up_proj.weight", (sh, h)),
                  (x + "shared_experts.down_proj.weight", (h, sh))]


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def test_totals_units_and_stated_blocks():
    cfg, mdl = _cfg(), model.load(CFG_FILE)
    st = cfg["stated"]
    assert (len(mdl.tensors), mdl.nbytes) == (st["tensors"], st["bytes"]) == (723, 16156230912)
    assert (mdl.dtype, mdl.chunk, mdl.huffman_table) == ("float32", 262144, "per_chunk")
    pattern = cfg["hybrid_override_pattern"]
    assert len(pattern) == cfg["num_hidden_layers"] == 52
    assert len(mdl.units) == 53
    for i, (letter, unit) in enumerate(zip(pattern, mdl.units)):
        assert _kind(mdl, unit) == letter, i
        assert all(mdl.tensors[j].name.startswith(f"backbone.layers.{i}.") for j in unit)
        assert len(unit) == st["block_tensors"][letter]
        assert sum(mdl.tensor_bytes(j) for j in unit) == st["block_bytes"][letter]
    assert [mdl.tensors[j].name for j in mdl.units[-1]] == [
        "backbone.embeddings.weight", "backbone.norm_f.weight", "lm_head.weight"]
    chunk_floats = mdl.chunk // mdl.itemsize
    assert sum(t.numel < chunk_floats for t in mdl.tensors) == 214


def test_published_widths():
    cfg, mdl = _cfg(), model.load(CFG_FILE)
    shapes = {t.name: t.shape for t in mdl.tensors}
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    nh, hd = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    ng, ns = cfg["n_groups"], cfg["ssm_state_size"]
    inner, conv = nh * hd, nh * hd + 2 * ng * ns
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    e = cfg["moe_intermediate_size"]
    sh = cfg["moe_shared_expert_intermediate_size"]
    assert shapes["backbone.embeddings.weight"] == (v, h) == shapes["lm_head.weight"]
    assert not cfg["tie_word_embeddings"] and shapes["backbone.norm_f.weight"] == (h,)
    m, x, a = (f"backbone.layers.{cfg['hybrid_override_pattern'].index(k)}.mixer." for k in "ME*")
    assert shapes[m + "in_proj.weight"] == (2 * inner + 2 * ng * ns + nh, h) == (10304, 2688)
    assert shapes[m + "conv1d.weight"] == (conv, 1, cfg["conv_kernel"]) == (6144, 1, 4)
    assert cfg["use_conv_bias"] and shapes[m + "conv1d.bias"] == (conv,)
    for p in ("A_log", "D", "dt_bias"):
        assert shapes[m + p] == (nh,)
    assert shapes[m + "norm.weight"] == (inner,)
    assert shapes[m + "out_proj.weight"] == (h, inner)
    published = cfg["reduced"]["n_routed_experts"]["from"]
    assert (published, cfg["n_routed_experts"]) == (128, 8)
    assert shapes[x + "gate.weight"] == (published, h)
    assert shapes[x + "gate.e_score_correction_bias"] == (published,)
    for k in range(cfg["n_routed_experts"]):
        assert shapes[x + f"experts.{k}.up_proj.weight"] == (e, h) == (1856, 2688)
        assert shapes[x + f"experts.{k}.down_proj.weight"] == (h, e)
    assert not any(".gate_proj" in n for n in shapes)  # relu2 experts
    assert shapes[x + "shared_experts.up_proj.weight"] == (sh, h) == (3712, 2688)
    assert shapes[x + "shared_experts.down_proj.weight"] == (h, sh)
    assert shapes[a + "q_proj.weight"] == (q, h) and shapes[a + "o_proj.weight"] == (h, q)
    assert shapes[a + "k_proj.weight"] == (kv, h) == shapes[a + "v_proj.weight"] == (256, 2688)


def test_the_chips_shares_make_up_the_layer():
    """Each of the 16 chips holds experts 8k..8k+7 of a MoE layer and the
    rest of it whole; the configuration's MoE blocks are chip 0's."""
    cfg, mdl = _cfg(), model.load(CFG_FILE)
    ep = cfg["deployment"]["expert_parallel"]
    published, held = cfg["reduced"]["n_routed_experts"]["from"], cfg["n_routed_experts"]
    assert ep * held == published
    whole = _moe_layer(cfg, published, range(published))
    shares = [_moe_layer(cfg, published, range(k * held, (k + 1) * held)) for k in range(ep)]
    replicated = [t for t in whole if ".experts." not in t[0]]
    experts = [[t for t in s if ".experts." in t[0]] for s in shares]
    flat = [t for s in experts for t in s]
    assert len(flat) == len(set(flat))  # no expert tensor on two chips
    assert set(flat) | set(replicated) == set(whole) and not set(flat) & set(replicated)
    assert all([t for t in s if ".experts." not in t[0]] == replicated for s in shares)
    size = lambda ts: sum(_numel(s) for _, s in ts)  # noqa: E731
    assert size(replicated) + sum(size(s) for s in experts) == size(whole)
    for i, letter in enumerate(cfg["hybrid_override_pattern"]):
        if letter == "E":
            got = [(mdl.tensors[j].name, mdl.tensors[j].shape) for j in mdl.units[i]]
            assert got == [(n.format(i=i), s) for n, s in shares[0]]


def _read(trace):
    return harness._load(READER, "combine_roofline").read({"trace": trace})


def test_combine_roofline_on_a_synthetic_trace():
    tr = {"bytes": 3.35e9, "device_ops": [
        ["void huf_pc_decode_kernel<1>(Args)", 0.004],
        ["void combine_cells_kernel<(Layout)3>(Bufs, int const*)", 0.003],
        ["void combine_cells_kernel<(Layout)1>(Bufs, int const*)", 0.001]]}
    assert _read(tr) == pytest.approx(100.0 * (2 * 3.35e9 / 3.35e12) / 0.004)
    assert _read(dict(tr, device_ops=tr["device_ops"][:1])) is None
    assert _read(dict(tr, bytes=0)) is None
    assert _read(None) is None


TINY_HYBRID = {
    "source": "tests only",
    "container": {"dtype": "float32", "chunk": 262144, "huffman_table": "per_chunk"},
    "checkpoint": {
        "head": [["backbone.embeddings.weight", [300, 256]]],
        "layers": [
            {"first": 0, "count": 1, "tensors": [
                ["backbone.layers.{i}.norm.weight", [256]],
                ["backbone.layers.{i}.mixer.in_proj.weight", [40, 256]],
                ["backbone.layers.{i}.mixer.conv1d.weight", [192, 1, 4]],
                ["backbone.layers.{i}.mixer.conv1d.bias", [192]],
                ["backbone.layers.{i}.mixer.A_log", [4]],
                ["backbone.layers.{i}.mixer.D", [4]],
                ["backbone.layers.{i}.mixer.dt_bias", [4]],
                ["backbone.layers.{i}.mixer.norm.weight", [128]],
                ["backbone.layers.{i}.mixer.out_proj.weight", [256, 128]]]},
            {"first": 1, "count": 1, "tensors": [
                ["backbone.layers.{i}.norm.weight", [256]],
                ["backbone.layers.{i}.mixer.gate.weight", [16, 256]],
                ["backbone.layers.{i}.mixer.gate.e_score_correction_bias", [16]],
                {"each": "e", "count": 2, "tensors": [
                    ["backbone.layers.{i}.mixer.experts.{e}.up_proj.weight", [64, 256]],
                    ["backbone.layers.{i}.mixer.experts.{e}.down_proj.weight", [256, 64]]]},
                ["backbone.layers.{i}.mixer.shared_experts.up_proj.weight", [128, 256]],
                ["backbone.layers.{i}.mixer.shared_experts.down_proj.weight", [256, 128]]]},
            {"first": 2, "count": 1, "tensors": [
                ["backbone.layers.{i}.norm.weight", [256]],
                ["backbone.layers.{i}.mixer.q_proj.weight", [256, 256]],
                ["backbone.layers.{i}.mixer.k_proj.weight", [32, 256]],
                ["backbone.layers.{i}.mixer.v_proj.weight", [32, 256]],
                ["backbone.layers.{i}.mixer.o_proj.weight", [256, 256]]]},
        ],
        "tail": [["backbone.norm_f.weight", [256]], ["lm_head.weight", [64, 256]]],
    },
}


@pytest.fixture
def hybrid_root(tmp_path):
    """A checkout root whose one cell runs the resident mix on a tiny fp32
    hybrid checkpoint (one Mamba, one MoE and one attention block; the
    embedding one chunk and a tail), with the new cell's metrics."""
    shutil.copytree(PB, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "port_bench" / "configs" / "tiny-hybrid.json").write_text(json.dumps(TINY_HYBRID))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny-hybrid", "source": "tests",
                         "file": "port_bench/configs/tiny-hybrid.json", "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": "tiny_hybrid.resident", "config": "tiny-hybrid",
                           "traffic": "resident", "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            assert "nemotron3nano.resident" in m["workloads"], m["name"]
            m["workloads"] = ["tiny_hybrid.resident"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_a_traced_fp32_hybrid_run_on_the_cpu(hybrid_root, capsys):
    """The CPU has no device kernels, so the reader finds no K2 time and
    the line leaves the metric out (it reads a number on the card)."""
    rc, res = run_cell(hybrid_root, "tiny_hybrid.resident", trace=1, capsys=capsys)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) >= {"launches_per_GB.resident", "idle_share.resident"}
    assert "combine_roofline.resident" not in res["metrics"]
    assert res["breakdown"]["device_ops"] == []


def test_an_untraced_fp32_hybrid_run_on_the_cpu(hybrid_root, capsys):
    rc, res = run_cell(hybrid_root, "tiny_hybrid.resident", seed=2**31 + 19, capsys=capsys)
    assert rc == 0 and res["correct"] and res["attempted"] >= 8
    assert set(res["metrics"]) == {"resident_decode_GBps", "resident_block_p95_ms", "setup_s"}
