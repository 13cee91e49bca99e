"""PyTorch port: plane assembly (``ops/combine.py``).

The kernel's plain version fills cells as stored (payload bytes at an
unaligned offset), RLE or Huffman (rows of the symbol buffer), then
combines the planes; it is held bit-exactly against the JAX package's
``jax_transforms.combine_device`` (full chunks) and the golden
``byte_group.combine`` (every chunk, the odd-length tail included).  The
CUDA kernel is held against the plain version on the card in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zipnn_tpu.ops import byte_group, jax_transforms
from zipnn_tpu_torch.ops import combine

CS = 1024  # chunk size


def _case(total: int, num_buf: int, byte_reorder: int, bit_reorder: int, seed: int):
    """Planes of every chunk with a mix of cell kinds, and the kernel's
    inputs that describe them."""
    rng = np.random.default_rng(seed)
    n_chunks = -(-total // CS)
    row = CS // num_buf
    payload = bytearray(rng.integers(0, 256, 3, dtype=np.uint8).tobytes())
    hsym = np.zeros((n_chunks * num_buf, row), np.uint8)
    kinds, srcs, planes = [], [], []
    n_huf = 0
    for c in range(n_chunks):
        clen = min(CS, total - c * CS)
        lens = byte_group.plane_lengths(clen, num_buf, byte_reorder)
        cp = []
        for b in range(num_buf):
            kind = (c + 2 * b) % 3
            if kind == 1:
                v = int(rng.integers(0, 256))
                p = np.full(lens[b], v, np.uint8)
                src = v
            else:
                p = rng.integers(0, 256, lens[b], dtype=np.uint8)
                if kind == 0:
                    payload += rng.integers(0, 256, 1 + c, dtype=np.uint8).tobytes()
                    src = len(payload)
                    payload += p.tobytes()
                else:
                    hsym[n_huf, : lens[b]] = p
                    src = n_huf
                    n_huf += 1
            kinds.append(kind)
            srcs.append(src)
            cp.append(p)
        planes.append(cp)
    t = torch.from_numpy
    args = (
        t(np.frombuffer(bytes(payload), np.uint8).copy()), t(hsym.reshape(-1)),
        t(np.asarray(kinds, np.int32)), t(np.asarray(srcs, np.int64)), row, CS,
        total, num_buf, byte_reorder, bit_reorder,
    )
    return args, planes


def _golden(planes, total, num_buf, byte_reorder, bit_reorder):
    parts = []
    for c, cp in enumerate(planes):
        clen = min(CS, total - c * CS)
        parts.append(byte_group.combine(cp, clen, num_buf, byte_reorder, bit_reorder))
    return np.concatenate(parts)


def _run(args):
    total = args[6]
    out = torch.full((-(-total // 4) * 4,), 0xAA, dtype=torch.uint8)
    combine.combine_cells(*args, out)
    return out


@pytest.mark.parametrize(
    "num_buf,bit_reorder,total",
    [(2, 1, 3 * CS + 301), (2, 0, 3 * CS + 302), (1, 1, 4 * CS + 7), (2, 1, 3 * CS)],
    ids=["bf16-odd-tail", "fp16-even-tail", "fp8-tail", "bf16-full"],
)
def test_plain_matches_golden_and_jax(num_buf, bit_reorder, total):
    args, planes = _case(total, num_buf, 10, bit_reorder, seed=total)
    out = _run(args).numpy()
    np.testing.assert_array_equal(
        out[:total], _golden(planes, total, num_buf, 10, bit_reorder)
    )
    assert not np.any(out[total:])  # word padding is written as zero
    full = total // CS
    pw = np.stack([
        np.stack([p.view("<u4") for p in planes[c]]) for c in range(full)
    ])  # [full, num_buf, plane_words]
    want = np.asarray(
        jax_transforms.combine_device(jnp.asarray(pw), num_buf, 10, bit_reorder)
    )
    np.testing.assert_array_equal(out[: full * CS].view("<u4").reshape(full, -1), want)


@pytest.mark.parametrize("byte_reorder", [1, 8])
def test_plain_zero_fill_modes(byte_reorder):
    total = 2 * CS + 500
    args, planes = _case(total, 2, byte_reorder, 0, seed=byte_reorder)
    out = _run(args).numpy()
    np.testing.assert_array_equal(out[:total], _golden(planes, total, 2, byte_reorder, 0))


def test_four_planes_not_ported():
    args, _ = _case(CS, 2, 10, 1, seed=3)
    args = args[:7] + (4,) + args[8:]
    with pytest.raises(NotImplementedError, match="M4"):
        combine.combine_cells(*args, torch.zeros(CS, dtype=torch.uint8))

