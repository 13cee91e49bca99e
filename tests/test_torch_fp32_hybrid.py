"""PyTorch port: fp32 master weights of a hybrid Mamba-2 / MoE / attention
model on the CPU (``device="cpu"``, the kernels' plain versions), through
the serving path the resident benchmark runs.

One block of each kind of NVIDIA Nemotron-H (a Mamba-2 mixer, a MoE layer
with relu2 experts, a GQA attention layer), at the model's own trailing
widths with rows cut so each tensor holds at most one full 256 KB chunk
and a tail, down to the 64- and 128-float tensors (``A_log``, ``D``,
``dt_bias``, the router's bias).  Per block:

* ``ShardEncoder.compress_all`` (per-chunk tables) writes, byte for byte,
  the JAX package's numpy-engine container of each tensor;
* ``ShardDecoder.stage`` + ``decompress_stacked`` returns every tensor bit
  for bit;
* ``kernels.combined_bytes`` (K2's bytes by cell kind) adds up to the
  staged plans' cells by kind, and so to the stack's original bytes.
"""
import pytest
import torch

import zipnn_tpu
from zipnn_tpu_torch import ZipNN, codec
from zipnn_tpu_torch.io.serving import ShardDecoder, ShardEncoder
from zipnn_tpu_torch.ops import decode, kernels

CHUNK = 262144
HIDDEN = 2688

BLOCKS = {
    "mamba": [
        ("norm", (HIDDEN,)),
        ("mixer.in_proj", (4, HIDDEN)),
        ("mixer.conv1d.weight", (6144, 1, 4)),
        ("mixer.conv1d.bias", (6144,)),
        ("mixer.A_log", (64,)),
        ("mixer.D", (64,)),
        ("mixer.dt_bias", (64,)),
        ("mixer.norm", (4096,)),
        ("mixer.out_proj", (17, 4096)),
    ],
    "moe": [
        ("norm", (HIDDEN,)),
        ("mixer.gate", (4, HIDDEN)),
        ("mixer.gate.e_score_correction_bias", (128,)),
        ("mixer.experts.0.up_proj", (4, HIDDEN)),
        ("mixer.experts.0.down_proj", (40, 1856)),
        ("mixer.shared_experts.down_proj", (4, 3712)),
    ],
    "attention": [
        ("norm", (HIDDEN,)),
        ("mixer.q_proj", (4, HIDDEN)),
        ("mixer.k_proj", (2, HIDDEN)),
        ("mixer.v_proj", (2, HIDDEN)),
        ("mixer.o_proj", (17, 4096)),
    ],
}


def _tensors(kind):
    g = torch.Generator().manual_seed(1900 + sorted(BLOCKS).index(kind))
    return [torch.randn(shape, generator=g) * 0.05 for _, shape in BLOCKS[kind]]


@pytest.fixture(scope="module")
def blocks():
    """Each block's tensors, the port's containers of them, their staged
    handles, and one stacked decode's outputs with ``combined_bytes`` and
    ``launches`` after it.  On one torch thread: the plain versions' many
    small ops run several times slower against JAX's CPU threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _blocks()
    finally:
        torch.set_num_threads(threads)
        kernels.reset_launches()


def _blocks():
    z = ZipNN(input_format="torch", engine="cuda", device="cpu", compression_chunk=CHUNK)
    enc = ShardEncoder(z, device="cpu")
    dec = ShardDecoder(to_device=True, device="cpu")
    out = {}
    for kind in BLOCKS:
        ts = _tensors(kind)
        cs = [bytes(c) for c in enc.compress_all(ts)]
        staged = [dec.stage(c) for c in cs]
        kernels.reset_launches()
        outs = dec.decompress_stacked(dec.stack(staged))
        out[kind] = {"tensors": ts, "containers": cs, "staged": staged, "outs": outs,
                     "combined": dict(kernels.combined_bytes),
                     "launches": dict(kernels.launches)}
    return out


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_containers_equal_the_reference(blocks, kind):
    b = blocks[kind]
    ref = zipnn_tpu.ZipNN(input_format="torch", engine="numpy", compression_chunk=CHUNK)
    for (name, _), t, c in zip(BLOCKS[kind], b["tensors"], b["containers"]):
        assert c == ref.compress(t), name


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_stacked_decode_is_bit_exact(blocks, kind):
    b = blocks[kind]
    assert len(b["outs"]) == len(b["tensors"])
    for (name, _), o, t in zip(BLOCKS[kind], b["outs"], b["tensors"]):
        assert torch.equal(o, t.reshape(-1).view(torch.uint8)), name
        assert torch.equal(o.view(torch.float32).reshape(t.shape), t), name


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_combined_bytes_follow_the_cells(blocks, kind):
    """Gaussian fp32 weights: the sign-and-exponent plane is Huffman-coded
    and the three mantissa planes are stored, in every tensor down to the
    64-float ones, so K2 copies three bytes in four from stored cells."""
    b = blocks[kind]
    want = dict.fromkeys(decode.KIND_NAMES, 0)
    for (name, _), t, s in zip(BLOCKS[kind], b["tensors"], b["staged"]):
        plan = s.staged.plan  # K2's cell descriptors, chunk-major
        lens = codec.plane_chunk_lengths(t.numel() * 4, CHUNK, 4, 220).T.reshape(-1)
        mine = {n: int(lens[plan.kinds == k].sum()) for k, n in enumerate(decode.KIND_NAMES)}
        assert mine == {"stored": 3 * t.numel(), "rle": 0, "huffman": t.numel()}, name
        for n in want:
            want[n] += mine[n]
    assert b["combined"] == want
    assert sum(want.values()) == sum(t.numel() * 4 for t in b["tensors"])
    assert b["launches"] == dict.fromkeys(kernels.launches, 0)  # plain versions: no launch


def test_reset_launches_zeroes_combined_bytes(blocks):
    dec = ShardDecoder(to_device=True, device="cpu")
    small = blocks["mamba"]["staged"][4]  # A_log: 64 floats, 256 bytes
    kernels.reset_launches()
    dec.decompress_stacked(dec.stack([small, small]))
    assert kernels.combined_bytes == {"stored": 2 * 3 * 64, "rle": 0, "huffman": 2 * 64}
    kernels.reset_launches()
    assert kernels.combined_bytes == dict.fromkeys(decode.KIND_NAMES, 0)
