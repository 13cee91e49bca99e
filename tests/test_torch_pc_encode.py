"""PyTorch port: the per-chunk-table compress of ``engine="cuda"``
(``ops/encode.py`` with ``ops/hist.py`` and ``huf_enc.huf_pc_encode``),
run here through the kernels' plain versions (``device="cpu"``), held
against the JAX package with tolerance 0:

* ``hist.hist_cells_plain`` equals ``jax_entropy.histogram_cells``;
* ``huf_enc.huf_pc_encode_plain`` equals ``jax_entropy.encode_streams``
  (stream bytes and ``total_bits``), with codes of up to 11 and 12 bits;
* every container equals ``zipnn_tpu``'s golden encoder
  (``codec.compress_payload_numpy``) byte for byte, and in one case the
  JAX package's device encode (``jax_codec.compress_payload``): four
  dtypes, ragged tails, RLE and raw cells, a constant cell above the HUF
  block limit (raw), ``check_th_after_percent`` 0 and 10 with a plane
  abandoned, several batches with the check in the second, and host
  array, host tensor and ``bytes`` inputs;
* a container decodes back through the port's own decode.

The CUDA kernels run in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import zipnn_tpu
from zipnn_tpu import codec as ref_codec
from zipnn_tpu.ops import jax_codec, jax_entropy
from zipnn_tpu.ops.entropy import huf as ref_huf
from zipnn_tpu_torch import ZipNN, codec
from zipnn_tpu_torch.ops import encode, hist, huf_enc

CHUNK = 1024
DTYPES = [torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float32]


def _tensor(dtype, nbytes: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    size = nbytes // torch.empty(0, dtype=dtype).element_size()
    return torch.from_numpy((rng.standard_normal(size) * 0.05).astype(np.float32)).to(dtype)


def _port(x, chunk=CHUNK, **kw) -> bytes:
    return bytes(ZipNN(input_format="torch", engine="cuda", device="cpu",
                       compression_chunk=chunk, **kw).compress(x))


def _golden(x, chunk=CHUNK, **kw) -> bytes:
    return bytes(zipnn_tpu.ZipNN(input_format="torch", engine="numpy",
                                 compression_chunk=chunk, **kw).compress(x))


@pytest.mark.parametrize("rows,width", [(1, 1), (6, 33), (40, 256)])
def test_hist_cells_plain_matches_jax(rows, width):
    rng = np.random.default_rng(width)
    data = np.clip(rng.normal(120, 2, (rows, 4 * width)), 0, 255).astype(np.uint8)
    data[0, ::3] = 255
    if rows > 2:
        data[2] = 7  # a constant row
    got = hist.hist_cells(torch.from_numpy(data.view("<i4").copy()))
    want = np.asarray(jax_entropy.histogram_cells(jnp.asarray(data)))
    assert got.dtype == torch.int32 and got.shape == (rows, 256)
    np.testing.assert_array_equal(got.numpy(), want)


def _geometric_table(n_syms: int, max_bits: int, seed: int):
    """A table of codes up to ``max_bits`` long from geometric counts."""
    rng = np.random.default_rng(seed)
    syms = rng.permutation(256)[:n_syms]
    count = np.zeros(256, np.int64)
    count[syms] = np.maximum(1, (1 << 20) >> np.minimum(np.arange(n_syms), 40))
    lengths = ref_huf.build_code_lengths(count, max_bits)
    tlog = int(lengths.max())
    return syms, lengths, ref_huf.canonical_values(lengths, tlog), tlog


@pytest.mark.parametrize("seg", [4, 60, 512, 1028])
def test_huf_pc_encode_plain_matches_jax(seg):
    """Each cell its own table: 8, 11 and 12 bits at most; each stream
    equals ``encode_streams`` and the golden ``encode_stream``."""
    cells = [_geometric_table(n, b, seed=seg + i)
             for i, (n, b) in enumerate([(9, 8), (40, 11), (200, 12)])]
    assert [c[3] for c in cells] == [8, 11, 12]
    rng = np.random.default_rng(seg)
    syms = np.stack([rng.choice(c[0], 4 * seg) for c in cells]).astype(np.uint8)
    syms[2, :3] = cells[2][0][-1]  # the longest code
    words = torch.from_numpy(syms.reshape(-1).view("<i4").copy())
    streams = torch.arange(4 * len(cells), dtype=torch.int64) * (seg // 4)
    tables = torch.from_numpy(np.stack([huf_enc.pack_pc_table(v, l) for _, l, v, _ in cells]))
    rows, total = huf_enc.huf_pc_encode(words, tables, seg, streams)
    assert rows.shape == (12, (12 * seg + 32) // 32)
    nb = np.stack([c[1] for c in cells]).astype(np.uint32).reshape(-1)
    vb = np.stack([c[2] for c in cells]).astype(np.uint32).reshape(-1)
    off = np.repeat(np.arange(len(cells), dtype=np.int32) * 256, 4)
    wpr = (seg * 12 + 1 + 31) // 32 + 1
    w_j, t_j = jax_entropy.encode_streams(
        jnp.asarray(syms.reshape(-1, seg)), jnp.asarray(nb), jnp.asarray(vb),
        jnp.asarray(off), seg_len=seg, words_per_row=wpr)
    np.testing.assert_array_equal(total.numpy(), np.asarray(t_j))
    rb = rows.numpy().view(np.uint8)
    jb = np.asarray(w_j).astype("<u4").view(np.uint8).reshape(12, -1)
    for s in range(12):
        n = (int(total[s]) + 7) // 8
        c = cells[s // 4]
        want = ref_huf.encode_stream(syms.reshape(-1, seg)[s], c[2], c[1])
        assert bytes(rb[s, :n]) == bytes(jb[s, :n]) == want, s


@pytest.mark.parametrize("pct", [0, 10])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_pc_encode_byte_identical(dtype, pct):
    x = _tensor(dtype, 30 * CHUNK + 28, seed=pct)
    got = _port(x, check_th_after_percent=pct)
    assert encode.last_timings["encoder"] == "huf_pc_encode"
    assert got == _golden(x, check_th_after_percent=pct)


def _planes(n_chunks, seed=3):
    """Two planes (mode 10, no rotation): plane 1 a compressible N(128, 3),
    plane 0 random."""
    rng = np.random.default_rng(seed)
    half = CHUNK // 2
    hi = np.clip(rng.normal(128, 3, (n_chunks, half)), 0, 255).astype(np.uint8)
    lo = rng.integers(0, 256, (n_chunks, half), dtype=np.uint8)
    return lo, hi


def _join(lo, hi):
    out = np.empty(lo.shape + (2,), np.uint8)
    out[..., 0], out[..., 1] = lo, hi
    return out.reshape(-1)


def _pair(data, pct=10, chunk=CHUNK):
    got = codec.compress_payload(data, 2, 0, 10, chunk, engine="cuda",
                                 check_th_after_percent=pct, device="cpu")
    want = ref_codec.compress_payload_numpy(data, 2, 0, 10, chunk,
                                            check_th_after_percent=pct)
    return bytes(got), bytes(want)


@pytest.mark.parametrize("per_batch", [None, 3])
@pytest.mark.parametrize("pct", [0, 10])
def test_abandoned_plane_and_batches(monkeypatch, pct, per_batch):
    """40 chunks + a tail: the check runs after chunk 5 (in the second
    batch of 3 chunks).  Plane 0 is random up to it, so it is abandoned,
    and compressible after it, with an RLE cell: with the check on, every
    later cell of plane 0 (the RLE cell and the tail too) stores raw."""
    if per_batch:
        monkeypatch.setattr(encode, "batch_chunks", lambda cs, stride: per_batch)
    lo, hi = _planes(41)
    lo[6:] = hi[6:] ^ 0x55  # compressible from chunk 6 on
    lo[9] = 0x42            # an RLE cell
    hi[12] = 0x17
    data = _join(lo, hi)[: 40 * CHUNK + 300]
    assert codec.check_abandon_index(41, pct) == (5 if pct else None)
    got, want = _pair(data, pct)
    assert got == want
    assert encode.last_timings["batches"] == (14 if per_batch else 1)
    types, starts, _ = ref_codec.parse_tables(got, 2, 41)
    sizes = np.diff(starts, axis=1)
    assert not types[0, :6].any()              # random: raw
    assert types[1, :40].all() and sizes[1, 12] == 1  # RLE on plane 1
    if pct:
        assert not types[0].any()              # abandoned after the check
    else:
        assert types[0, 6:40].all() and sizes[0, 9] == 1


@pytest.mark.parametrize("tail", [0, 1, 2, 511, 513])
def test_rle_raw_cells_and_ragged_tails(tail):
    lo, hi = _planes(6, seed=tail)
    lo[1] = 9                          # RLE
    hi[2] = np.arange(CHUNK // 2) % 256  # flat: raw by the (n >> 7) + 4 rule
    hi[3, :5] = [0, 1, 2, 3, 4]        # a wider table
    data = _join(lo, hi)[: 5 * CHUNK + tail]
    got, want = _pair(data)
    assert got == want


def test_constant_cell_above_block_limit_is_raw():
    """bf16 at 512 KB chunks: 256 KB planes exceed HUF_BLOCKSIZE_MAX, so a
    constant cell stores raw, not RLE (the golden order of checks)."""
    chunk = 512 << 10
    x = torch.full((chunk // 2 + 20,), 0.25, dtype=torch.bfloat16)
    got = _port(x, chunk=chunk)
    assert got == _golden(x, chunk=chunk)
    after = ZipNN(engine="cuda", device="cpu")._retrieve_header(memoryview(got))
    types, _, _ = ref_codec.parse_tables(got[after:], 2, 2)
    assert not types[:, 0].any() and types[:, 1].all()


def test_matches_jax_device_encode():
    """One small case against the JAX package's device pipeline on the
    CPU (its per-cell histogram, ``_plan_cell`` and ``encode_streams``)."""
    lo, hi = _planes(7, seed=4)
    lo[2] = 200
    data = _join(lo, hi)[: 6 * CHUNK + 100]
    want = jax_codec.compress_payload(data, 2, 0, 10, CHUNK, check_th_after_percent=10)
    assert _pair(data)[0] == bytes(want)


def test_inputs_and_roundtrip():
    """Host array, host tensor and ``bytes`` give the golden container,
    which decodes back through the port."""
    x = _tensor(torch.bfloat16, 12 * CHUNK + 6, seed=9)
    want = _golden(x)
    raw = x.view(torch.uint8).numpy().tobytes()
    assert _port(x) == want
    kw = dict(engine="cuda", device="cpu", compression_chunk=CHUNK)
    assert bytes(ZipNN(bytearray_dtype="bfloat16", **kw).compress(raw)) == bytes(
        zipnn_tpu.ZipNN(bytearray_dtype="bfloat16", engine="numpy",
                        compression_chunk=CHUNK).compress(raw))
    data = np.frombuffer(raw, np.uint8)
    got = codec.compress_payload(data, 2, 1, 10, CHUNK, engine="cuda",
                                 check_th_after_percent=10, device="cpu")
    assert bytes(got) == ref_codec.compress_payload_numpy(data, 2, 1, 10, CHUNK,
                                                          check_th_after_percent=10)
    y = ZipNN(input_format="torch", engine="cuda", device="cpu").decompress(want)
    assert torch.equal(y.view(torch.int16), x.view(torch.int16))
