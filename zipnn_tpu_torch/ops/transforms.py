"""Byte-group transforms on 32-bit words, in plain PyTorch.

The torch counterpart of the JAX package's ``ops/jax_transforms.py``: the
bf16 sign-bit rotation (reference csrc/data_manipulation_dtype16.c:10-20,
145-155) and the 2-plane combine (dtype16.c:167-216) on words.  These are
the plain versions the combine kernel (``ops/combine.py``) is held
against (``combine_2`` and ``revert_sign_16`` are what its plain version
runs), and they run on any device.

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

