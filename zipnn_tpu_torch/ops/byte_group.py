"""Byte-plane grouping and sign-bit rotation — numpy golden model.

These are the format-bearing data transforms of the ``.znn`` codec, the numpy
equivalents of the reference C kernels (csrc/data_manipulation_dtype16.c and
data_manipulation_dtype32.c).  The torch transforms in
``zipnn_tpu_torch.ops.transforms`` and the CUDA combine kernel
(``zipnn_tpu_torch.ops.combine``) are validated bit-for-bit against this
module.

Semantics reproduced exactly, including quirks:

* The 16-bit sign-bit rotation processes the input as uint32 *pairs* of
  lanes; a trailing ``len % 4`` byte tail is left untouched
  (dtype16.c:23-29).  Same for the inverse.
* 2-plane split of an odd-length buffer puts the extra byte in plane 0
  (dtype16.c:71-75, 99-101).
* 4-plane split of a ``len % 4 != 0`` buffer gives planes ``b < len % 4``
  one extra byte (dtype32.c:84-91).  (fp32 payloads are always a multiple
  of 4 bytes so this path is only reachable for raw-byte inputs.)
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# sign-bit rotation (bit_reorder == 1)
# ---------------------------------------------------------------------------

def reorder_sign_16(buf: np.ndarray) -> np.ndarray:
    """bf16 lanes: [s eeeeeeee mmmmmmm] -> [eeeeeeee s mmmmmmm].

    Operates on an even number of 16-bit lanes (len//4 uint32 words); the
    remaining tail bytes are copied through unchanged, matching
    reorder_all_floats_dtype16 (dtype16.c:23-29).
    """
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = buf.copy()
    nwords = buf.size // 4
    if nwords:
        u = out[: nwords * 4].view(np.uint32)
        sign = (u >> np.uint32(8)) & np.uint32(0x800080)
        exp = (u << np.uint32(1)) & np.uint32(0xFF00FF00)
        man = u & np.uint32(0x7F007F)
        u[:] = exp | sign | man
    return out


def revert_sign_16(buf: np.ndarray) -> np.ndarray:
    """Inverse of :func:`reorder_sign_16` (dtype16.c:145-155)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = buf.copy()
    nwords = buf.size // 4
    if nwords:
        u = out[: nwords * 4].view(np.uint32)
        sign = (u << np.uint32(8)) & np.uint32(0x80008000)
        exp = (u >> np.uint32(1)) & np.uint32(0x7F807F80)
        man = u & np.uint32(0x7F007F)
        u[:] = sign | exp | man
    return out


def reorder_sign_32(buf: np.ndarray) -> np.ndarray:
    """fp32: [s e8 m23] -> [e8 s m23] per little-endian uint32 word
    (dtype32.c:39-49)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = buf.copy()
    nwords = buf.size // 4
    if nwords:
        u = out[: nwords * 4].view(np.uint32)
        sign = (u >> np.uint32(8)) & np.uint32(0x800000)
        exp = (u << np.uint32(1)) & np.uint32(0xFF000000)
        man = u & np.uint32(0x7FFFFF)
        u[:] = exp | sign | man
    return out


def revert_sign_32(buf: np.ndarray) -> np.ndarray:
    """Inverse of :func:`reorder_sign_32` (dtype32.c:275-285)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = buf.copy()
    nwords = buf.size // 4
    if nwords:
        u = out[: nwords * 4].view(np.uint32)
        sign = (u << np.uint32(8)) & np.uint32(0x80000000)
        exp = (u >> np.uint32(1)) & np.uint32(0x7F800000)
        man = u & np.uint32(0x7FFFFF)
        u[:] = sign | exp | man
    return out


# ---------------------------------------------------------------------------
# byte-plane split / combine
# ---------------------------------------------------------------------------

def plane_lengths(total_len: int, num_buf: int, byte_reorder: int) -> List[int]:
    """Uncompressed per-plane lengths for one chunk of ``total_len`` bytes.

    Matches the split allocations (dtype16.c:70-75, dtype32.c:84-91) and the
    decompressor's last-chunk remainder distribution (zipnn_core.c:1006-1028):
    plane ``b`` gets ``total_len // num_buf`` bytes plus one if
    ``b < total_len % num_buf``.
    """
    if byte_reorder in (8, 1) and num_buf == 2:
        return [total_len // 2, 0]
    q, r = divmod(total_len, num_buf)
    return [q + (1 if b < r else 0) for b in range(num_buf)]


def split(
    buf: np.ndarray, num_buf: int, byte_reorder: int, bit_reorder: int
) -> List[np.ndarray]:
    """Split one chunk into byte planes (after optional sign rotation).

    Reference: split_bytearray_dtype8/16/32 (dtype16.c:33-138,
    dtype32.c:219-268).
    """
    buf = np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)
    if num_buf == 1:
        if byte_reorder != 10:
            raise ValueError(f"Unsupported bytes_mode {byte_reorder} for 1 plane")
        return [buf.copy()]
    if num_buf == 2:
        if bit_reorder == 1:
            buf = reorder_sign_16(buf)
        if byte_reorder == 10:
            return [buf[0::2].copy(), buf[1::2].copy()]
        if byte_reorder == 1:  # truncate LSByte: keep even (low) bytes
            return [buf[0::2].copy(), np.empty(0, np.uint8)]
        if byte_reorder == 8:  # truncate MSByte: keep odd (high) bytes
            return [buf[1::2].copy(), np.empty(0, np.uint8)]
        raise ValueError(f"Unsupported bytes_mode {byte_reorder} for 2 planes")
    if num_buf == 4:
        if bit_reorder == 1:
            buf = reorder_sign_32(buf)
        if byte_reorder == 220:
            return [buf[b::4].copy() for b in range(4)]
        raise ValueError(f"Unsupported bytes_mode {byte_reorder} for 4 planes")
    raise ValueError(f"Unsupported num_buf {num_buf}")


def combine(
    planes: Sequence[np.ndarray],
    total_len: int,
    num_buf: int,
    byte_reorder: int,
    bit_reorder: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Inverse of :func:`split` for one chunk.

    Reference: combine_buffers_dtype16/32 (dtype16.c:167-216,
    dtype32.c:391-456).  ``out`` may be a preallocated uint8 view of length
    ``total_len`` (e.g. a slice of the full result buffer).
    """
    if out is None:
        out = np.empty(total_len, dtype=np.uint8)
    if out.size != total_len:
        raise ValueError("output view size mismatch")

    if num_buf == 1:
        out[:] = planes[0][:total_len]
        return out

    if num_buf == 2:
        if byte_reorder == 10:
            out[0::2] = planes[0]
            out[1::2] = planes[1]
        elif byte_reorder == 1:  # LSByte kept in plane 0, high byte zeroed
            out[0::2] = planes[0]
            out[1::2] = 0
        elif byte_reorder == 8:  # MSByte kept in plane 0, low byte zeroed
            out[0::2] = 0
            out[1::2] = planes[0]
        else:
            raise ValueError(f"Unsupported bytes_mode {byte_reorder} for 2 planes")
        if bit_reorder == 1:
            out[:] = revert_sign_16(out)
        return out

    if num_buf == 4:
        if byte_reorder != 220:
            raise ValueError(f"Unsupported bytes_mode {byte_reorder} for 4 planes")
        for b in range(4):
            out[b::4] = planes[b]
        if bit_reorder == 1:
            out[:] = revert_sign_32(out)
        return out

    raise ValueError(f"Unsupported num_buf {num_buf}")
