"""PyTorch port on the card: each CUDA kernel against its plain version,
and the whole decode against the golden model.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
This file imports neither ``jax`` nor ``zipnn_tpu``, so it runs where only
PyTorch is installed:

    ZIPNN_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_cuda.py -q

(``ZIPNN_TPU_TESTS=1`` keeps ``tests/conftest.py`` from importing JAX.)
"""
import numpy as np
import pytest
import torch

from zipnn_tpu_torch import CorruptChunkError, ZipNN
from zipnn_tpu_torch.ops import combine, decode, huf_pc, kernels
from zipnn_tpu_torch.ops.byte_group import plane_lengths
from zipnn_tpu_torch.ops.entropy import huf

pytestmark = pytest.mark.cuda
CHUNK = 16384


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(args, dev):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)


def _k1_inputs(sizes, seed):
    """Cells of several tables and lengths behind 0xFF junk bytes."""
    rng = np.random.default_rng(seed)
    row = max(sizes)
    parts, starts, lens, bits0, offs, olens, cells, headers = [], [], [], [], [], [], [], []
    pos = 0
    for i, n in enumerate(sizes):
        plane = np.clip(rng.normal(100 + 10 * i, 3 + 2 * i, n), 0, 255).astype(np.uint8)
        blob = huf.compress(plane)
        _, _, _, _, consumed = huf.read_stats(blob)
        headers.append(blob[:consumed])
        rest = blob[consumed:]
        ls = [int.from_bytes(rest[j : j + 2], "little") for j in (0, 2, 4)]
        ls.append(len(rest) - 6 - sum(ls))
        parts.append(b"\xff" * 29 + rest[6:])
        pos += 29
        o = i * row
        for k, (ln, seg) in enumerate(zip(ls, huf.segment_sizes(n))):
            s = rest[6 + sum(ls[:k]) : 6 + sum(ls[: k + 1])]
            starts.append(pos)
            lens.append(ln)
            bits0.append(8 * (ln - 1) + s[-1].bit_length() - 1)
            offs.append(o)
            olens.append(seg)
            cells.append(i)
            pos += ln
            o += seg
    tables, tlogs, _ = huf_pc.cell_tables(headers)
    t = torch.from_numpy
    return (
        t(np.frombuffer(b"".join(parts), np.uint8).copy()), t(np.asarray(starts, np.int64)),
        t(np.asarray(lens, np.int32)), t(np.asarray(bits0, np.int32)),
        t(np.asarray(offs, np.int64)), t(np.asarray(olens, np.int32)),
        t(np.asarray(cells, np.int32)), t(tlogs), t(tables), len(sizes) * row,
    )


def test_huf_pc_kernel_matches_plain(card):
    sizes = [4096, 4097, 1001, 777, 4098, 257, 131072]
    args = _k1_inputs(sizes, seed=1)
    want, want_bl = huf_pc.huf_pc_decode(*args)
    got, got_bl = huf_pc.huf_pc_decode(*_to(args, card))
    torch.cuda.synchronize()
    row = max(sizes)
    for i, n in enumerate(sizes):
        assert torch.equal(got[i * row : i * row + n].cpu(), want[i * row : i * row + n]), i
    assert torch.equal(got_bl.cpu(), want_bl)
    assert not want_bl.any()


def _k2_inputs(total, num_buf, byte_reorder, bit_reorder, seed, cs=1024):
    rng = np.random.default_rng(seed)
    n_chunks = -(-total // cs)
    row = cs // num_buf
    payload = bytearray(rng.integers(0, 256, 5, dtype=np.uint8).tobytes())
    hsym = rng.integers(0, 256, (n_chunks * num_buf, row), dtype=np.uint8)
    kinds, srcs = [], []
    for c in range(n_chunks):
        lens = plane_lengths(min(cs, total - c * cs), num_buf, byte_reorder)
        for b in range(num_buf):
            kind = int(rng.integers(0, 3))
            if kind == 0:
                payload += rng.integers(0, 256, 1 + c, dtype=np.uint8).tobytes()
                src = len(payload)
                payload += rng.integers(0, 256, lens[b], dtype=np.uint8).tobytes()
            elif kind == 1:
                src = int(rng.integers(0, 256))
            else:
                src = c * num_buf + b
            kinds.append(kind)
            srcs.append(src)
    t = torch.from_numpy
    return (
        t(np.frombuffer(bytes(payload), np.uint8).copy()), t(hsym.reshape(-1)),
        t(np.asarray(kinds, np.int32)), t(np.asarray(srcs, np.int64)), row, cs,
        total, num_buf, byte_reorder, bit_reorder,
    )


@pytest.mark.parametrize("num_buf,byte_reorder,bit_reorder,total", [
    (2, 10, 1, 3 * 1024 + 301), (2, 10, 0, 5 * 1024), (1, 10, 1, 4 * 1024 + 7),
    (2, 8, 0, 2 * 1024 + 500), (2, 1, 0, 2 * 1024 + 501),
])
def test_combine_kernel_matches_plain(card, num_buf, byte_reorder, bit_reorder, total):
    args = _k2_inputs(total, num_buf, byte_reorder, bit_reorder, seed=total)
    n = -(-total // 4) * 4
    want = torch.full((n,), 0xAA, dtype=torch.uint8)
    combine.combine_cells(*args, want)
    got = torch.full((n,), 0xAA, dtype=torch.uint8, device=card)
    combine.combine_cells(*_to(args, card), got)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _raw(dtype, nbytes, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.float8_e4m3fn:
        return np.clip(rng.normal(56, 6, nbytes), 0, 255).astype(np.uint8)
    vals = (rng.standard_normal(nbytes // 2) * 0.05).astype(np.float32)
    if dtype == torch.bfloat16:
        return (vals.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8)
    return vals.astype(np.float16).view(np.uint8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float8_e4m3fn])
def test_decode_on_card_matches_golden(card, dtype):
    raw = _raw(dtype, 9 * CHUNK + 6002, seed=3)
    x = torch.from_numpy(raw.copy()).view(dtype)
    comp = ZipNN(input_format="torch", engine="numpy", compression_chunk=CHUNK).compress(x)
    kernels.reset_launches()
    y = ZipNN(input_format="torch", engine="cuda").decompress(comp)
    torch.cuda.synchronize()
    assert y.is_cuda and y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8))
    assert kernels.launches["huf_pc_decode"] > 0 and kernels.launches["combine_cells"] > 0
    ms = decode.kernel_ms()
    assert ms["huf_pc_decode"] > 0 and ms["combine_cells"] > 0


@pytest.mark.parametrize("raw", [
    b"", b"\x01\x02\x03", bytes(3 * CHUNK + 10),
    np.random.default_rng(2).integers(0, 256, 3 * CHUNK + 11, dtype=np.uint8).tobytes(),
], ids=["empty", "tiny", "all-rle", "all-stored"])
def test_decode_edge_containers_on_card(card, raw):
    comp = ZipNN(engine="numpy", compression_chunk=CHUNK).compress(raw)
    assert bytes(ZipNN(engine="cuda").decompress(comp)) == raw


def test_corrupt_stream_raises_on_card(card):
    raw = _raw(torch.bfloat16, 4 * CHUNK, seed=4)
    comp = bytes(ZipNN(engine="numpy", compression_chunk=CHUNK).compress(raw.tobytes()))
    z = ZipNN(engine="numpy")
    after = z._retrieve_header(memoryview(comp))
    plan = decode.build_plan(memoryview(comp)[after:], 2, 1, 10, CHUNK, raw.size)
    s0, ln = after + int(plan.starts[5]), int(plan.lens[5])
    for bit in range(8 * (ln // 2), 8 * (ln - 1)):
        bad = bytearray(comp)
        bad[s0 + bit // 8] ^= 1 << (bit % 8)
        try:
            ZipNN(engine="cuda", device="cpu").decompress(bytes(bad))
        except CorruptChunkError as exc:
            want = (exc.plane, exc.chunk, exc.stream)
            break
    else:
        pytest.fail("no rejected bit flip found")
    with pytest.raises(CorruptChunkError) as got:
        ZipNN(engine="cuda").decompress(bytes(bad))
    assert (got.value.plane, got.value.chunk, got.value.stream) == want
    assert want[2] == 1
