"""Byte-group transforms on 32-bit words, in plain PyTorch.

The torch counterpart of the JAX package's ``ops/jax_transforms.py``: the
bf16 and fp32 sign-bit rotations (reference
csrc/data_manipulation_dtype16.c:10-20, 145-155, dtype32.c:39-49,
275-285), the 2- and 4-plane splits the encoder runs on the card
(dtype16.c:78-102, dtype32.c:78-102) and the combines (dtype16.c:167-216,
dtype32.c:391-456) on words.  The combines are what the combine kernel's
plain version (``ops/combine.py``) runs; the splits are the encoder's
glue (``ops/encode.py``), as the JAX package computes them in XLA outside
any Pallas kernel.  Everything here runs on any device.

Words are int32 tensors carrying the uint32 bit pattern (little-endian
bytes, as a host ``np.view("<u4")``).  PyTorch has no shifts or
comparisons for ``uint32`` on the CPU, so the arithmetic runs in int64 on
the zero-extended value and truncates back to int32 at the end.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _u(words: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> zero-extended int64 value."""
    return words.to(torch.int64) & _M32


def _w(values: torch.Tensor) -> torch.Tensor:
    """int64 value in [0, 2^32) -> int32 bit pattern (low 32 bits)."""
    return values.to(torch.int32)


def reorder_sign_16(words: torch.Tensor) -> torch.Tensor:
    """Two bf16 lanes per word: [s e8 m7] -> [e8 s m7]."""
    w = _u(words)
    sign = (w >> 8) & 0x800080
    exp = (w << 1) & 0xFF00FF00
    man = w & 0x7F007F
    return _w(exp | sign | man)


def revert_sign_16(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`reorder_sign_16`."""
    w = _u(words)
    sign = (w << 8) & 0x80008000
    exp = (w >> 1) & 0x7F807F80
    man = w & 0x7F007F
    return _w(sign | exp | man)


def reorder_sign_32(words: torch.Tensor) -> torch.Tensor:
    """fp32 lanes: [s e8 m23] -> [e8 s m23]."""
    w = _u(words)
    sign = (w >> 8) & 0x800000
    exp = (w << 1) & 0xFF000000
    man = w & 0x7FFFFF
    return _w(exp | sign | man)


def revert_sign_32(words: torch.Tensor) -> torch.Tensor:
    """fp32 lanes: [e8 s m23] -> [s e8 m23] (inverse of the encoder's
    ``reorder_sign_32``)."""
    w = _u(words)
    sign = (w << 8) & 0x80000000
    exp = (w >> 1) & 0x7F800000
    man = w & 0x7FFFFF
    return _w(sign | exp | man)


def _bytes_of(w: torch.Tensor):
    return w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF


def _pack4(b0, b1, b2, b3) -> torch.Tensor:
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)


def combine_2(planes: torch.Tensor, bit_reorder: int) -> torch.Tensor:
    """2-plane combine of full chunks: [..., 2, n] -> [..., 2n] words.

    Plane 0 holds the even bytes, plane 1 the odd bytes; the sign rotation
    is reverted afterwards when ``bit_reorder`` is set.
    """
    p = _u(planes)
    a0, a1, a2, a3 = _bytes_of(p[..., 0, :])
    b0, b1, b2, b3 = _bytes_of(p[..., 1, :])
    lo = _pack4(a0, b0, a1, b1)
    hi = _pack4(a2, b2, a3, b3)
    w = _w(torch.stack([lo, hi], dim=-1).flatten(-2))
    return revert_sign_16(w) if bit_reorder else w


def _deinterleave(words: torch.Tensor, num_buf: int) -> torch.Tensor:
    """[..., n] words -> [..., num_buf, n // num_buf] words: plane ``b``
    holds bytes ``b, b + num_buf, ...`` of the little-endian byte
    stream."""
    *lead, n = words.shape
    by = words.contiguous().view(torch.uint8).reshape(*lead, 4 * n // num_buf, num_buf)
    planes = by.transpose(-1, -2).contiguous()
    return planes.view(torch.int32).reshape(*lead, num_buf, n // num_buf)


def split_2(words: torch.Tensor, bit_reorder: int) -> torch.Tensor:
    """2-plane split of full chunks: [..., n] -> [..., 2, n // 2] words.

    Plane 0 holds the even bytes, plane 1 the odd bytes, after the sign
    rotation when ``bit_reorder`` is set.
    """
    return _deinterleave(reorder_sign_16(words) if bit_reorder else words, 2)


def split_4(words: torch.Tensor, bit_reorder: int) -> torch.Tensor:
    """4-plane split of full chunks (mode 220): [..., n] -> [..., 4, n // 4]
    words; byte ``p`` of the chunk goes to plane ``p & 3``."""
    return _deinterleave(reorder_sign_32(words) if bit_reorder else words, 4)


def split_device(words: torch.Tensor, num_buf: int, byte_reorder: int,
                 bit_reorder: int) -> torch.Tensor:
    """Dispatch: [..., n] int32 words -> [..., num_buf, n // num_buf].

    One plane (fp8) passes the words through unrotated, as the golden
    ``byte_group.split`` does.
    """
    modes = {1: 10, 2: 10, 4: 220}
    if num_buf not in modes:
        raise ValueError(f"Unsupported num_buf {num_buf}")
    if byte_reorder != modes[num_buf]:
        raise ValueError(f"Unsupported bytes_mode {byte_reorder} for {num_buf} planes")
    if words.dtype != torch.int32:
        raise TypeError(f"split_device: words must be int32, got {words.dtype}")
    if num_buf == 1:
        return words.unsqueeze(-2)
    if num_buf == 2:
        return split_2(words, bit_reorder)
    return split_4(words, bit_reorder)


def split_bytes(rows: torch.Tensor, num_buf: int, byte_reorder: int, bit_reorder: int,
                lens) -> torch.Tensor:
    """Byte-wise split of full chunks of any size: [k, chunk] uint8 ->
    [k, num_buf, max(lens)] uint8, plane ``b`` in its first ``lens[b]``
    bytes (``codec.plane_chunk_lengths`` of a full chunk), zeros after.

    The golden ``byte_group.split`` of each chunk: the sign rotation on the
    chunk's whole words only (none in a chunk under 4 bytes), then byte
    ``p`` to plane ``p % num_buf``.  Index arithmetic on the rows' device;
    the inverse of ``combine.combine_bytes_kernel``.
    """
    modes = {1: 10, 2: 10, 4: 220}
    if modes.get(num_buf) != byte_reorder:
        raise ValueError(f"Unsupported bytes_mode {byte_reorder} for {num_buf} planes")
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError("split_bytes: rows must be [k, chunk] uint8")
    k, chunk = rows.shape
    w = chunk // 4
    if bit_reorder and num_buf > 1 and w:
        rotate = reorder_sign_16 if num_buf == 2 else reorder_sign_32
        head = rotate(rows[:, : 4 * w].contiguous().view(torch.int32)).view(torch.uint8)
        rows = torch.cat([head, rows[:, 4 * w :]], dim=1)
    out = torch.zeros((k, num_buf, max(lens)), dtype=torch.uint8, device=rows.device)
    for b in range(num_buf):
        out[:, b, : lens[b]] = rows[:, b::num_buf]
    return out


def combine_4(planes: torch.Tensor, bit_reorder: int) -> torch.Tensor:
    """4-plane combine of full chunks (mode 220): [..., 4, n] -> [..., 4n]
    words.

    Byte ``p`` of the chunk is byte ``p >> 2`` of plane ``p & 3``; the fp32
    sign rotation is reverted afterwards when ``bit_reorder`` is set.
    """
    p = _u(planes)
    by = [_bytes_of(p[..., b, :]) for b in range(4)]  # [plane][word byte]
    words = [_pack4(by[0][i], by[1][i], by[2][i], by[3][i]) for i in range(4)]
    w = _w(torch.stack(words, dim=-1).flatten(-2))
    return revert_sign_32(w) if bit_reorder else w
