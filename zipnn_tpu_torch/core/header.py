"""The 32-byte ``.znn`` frame header and the variable-length shape extension.

Byte layout (format-normative, reverse-engineered from the reference;
zipnn/zipnn.py:287-303, 373-394 and csrc/zipnn_core.c:121):

====  =======================================================================
byte  meaning
====  =======================================================================
0:2   magic ``b"ZN"``
2:5   writer version (major, minor, tiny)
5     byte_reorder mode (10 = 2-plane, 220 = 4-plane, ...)
6     bit_reorder (1 = sign bit rotated out of the exponent byte)
7     method (EnumMethod)
8     input format (EnumFormat)
9     delta mode (0 = none, 1 = byte, 2 = file)
10    lossy type, 11 lossy factor, 12 lossy-is-int
13    0 if not streaming, else 128 + log2(streaming_chunk)
14    log2(compression_chunk)
15    dtype code (core.dtypes)
16:24 original (uncompressed) length, uint64 LE
24:32 total frame length INCLUDING this header and the shape extension,
      uint64 LE
====  =======================================================================

For TORCH/NUMPY/JAX formats the header is followed by the packed tensor
shape (``pack_shape``, mirrors zipnn/util_torch.py:89-159).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

MAGIC = b"ZN"
HEADER_LEN = 32

# Version stamped into frames we write.  Kept at the reference's version so
# that reference readers (which do not check it) and our readers agree on the
# frame layout generation.
WRITER_VERSION = (0, 5, 3)


def pack_shape(shape: Sequence[int]) -> bytes:
    """Pack tensor dims with per-dim 1/2/4/8-byte width indicators."""
    out = bytearray()
    out.append(len(shape))
    for dim in shape:
        dim = int(dim)
        if dim < 0:
            raise ValueError("negative dimension in shape")
        if dim < 256:
            out.append(1)
            out += struct.pack("<B", dim)
        elif dim < 65536:
            out.append(2)
            out += struct.pack("<H", dim)
        elif dim < 4294967296:
            out.append(4)
            out += struct.pack("<I", dim)
        else:
            out.append(8)
            out += struct.pack("<Q", dim)
    return bytes(out)


def unpack_shape(buf) -> Tuple[Tuple[int, ...], int]:
    """Inverse of :func:`pack_shape`; returns (shape, bytes_consumed)."""
    buf = memoryview(buf)
    ndim = buf[0]
    dims = []
    i = 1
    while i < len(buf) and len(dims) < ndim:
        ind = buf[i]
        i += 1
        if ind == 1:
            (d,) = struct.unpack("<B", buf[i : i + 1])
            i += 1
        elif ind == 2:
            (d,) = struct.unpack("<H", buf[i : i + 2])
            i += 2
        elif ind == 4:
            (d,) = struct.unpack("<I", buf[i : i + 4])
            i += 4
        else:
            (d,) = struct.unpack("<Q", buf[i : i + 8])
            i += 8
        dims.append(d)
    return tuple(dims), i


def _log2_exact(value: int, what: str) -> int:
    if value <= 0 or (value & (value - 1)) != 0:
        raise ValueError(f"{what} must be a power of 2, got {value}")
    return value.bit_length() - 1


@dataclass
class Header:
    """Parsed/boxed representation of one frame header (+shape extension)."""

    byte_reorder: int = 0
    bit_reorder: int = 0
    method: int = 0
    input_format: int = 1
    delta_mode: int = 0
    lossy_type: int = 0
    lossy_factor: int = 0
    lossy_is_int: int = 0
    is_streaming: bool = False
    streaming_chunk: int = 1024 * 1024
    compression_chunk: int = 256 * 1024
    dtype_code: int = 0
    original_len: int = 0
    total_len: int = 0  # frame length incl. header+shape ext; 0 until sealed
    shape: Optional[Tuple[int, ...]] = None
    version: Tuple[int, int, int] = field(default=WRITER_VERSION)

    # -- encode ------------------------------------------------------------
    def to_bytes(self, include_shape: bool = True) -> bytes:
        h = bytearray(HEADER_LEN)
        h[0:2] = MAGIC
        h[2], h[3], h[4] = self.version
        h[5] = self.byte_reorder & 0xFF
        h[6] = self.bit_reorder & 0xFF
        h[7] = self.method & 0xFF
        h[8] = self.input_format & 0xFF
        h[9] = self.delta_mode & 0xFF
        h[10] = self.lossy_type & 0xFF
        h[11] = self.lossy_factor & 0xFF
        h[12] = self.lossy_is_int & 0xFF
        if self.is_streaming:
            h[13] = 128 + _log2_exact(self.streaming_chunk, "streaming_chunk")
        else:
            h[13] = 0
        h[14] = _log2_exact(self.compression_chunk, "compression_chunk")
        h[15] = self.dtype_code & 0xFF
        h[16:24] = int(self.original_len).to_bytes(8, "little")
        h[24:32] = int(self.total_len).to_bytes(8, "little")
        if include_shape and self.shape is not None:
            return bytes(h) + pack_shape(self.shape)
        return bytes(h)

    def ext_len(self) -> int:
        """Length of the shape extension this header will write."""
        if self.shape is None:
            return 0
        return len(pack_shape(self.shape))

    # -- decode ------------------------------------------------------------
    @classmethod
    def from_bytes(cls, buf, formats_with_shape=(2, 3, 5)) -> Tuple["Header", int]:
        """Parse one header (+shape ext if the format carries one).

        Returns (header, total_header_bytes_consumed).
        """
        mv = memoryview(buf)
        if len(mv) < HEADER_LEN:
            raise ValueError("Buffer shorter than a ZipNN header")
        if bytes(mv[0:2]) != MAGIC:
            raise ValueError("Header should start with ZN")
        streaming_val = mv[13]
        hdr = cls(
            byte_reorder=mv[5],
            bit_reorder=mv[6],
            method=mv[7],
            input_format=mv[8],
            delta_mode=mv[9],
            lossy_type=mv[10],
            lossy_factor=mv[11],
            lossy_is_int=mv[12],
            is_streaming=streaming_val > 127,
            streaming_chunk=(1 << (streaming_val - 128)) if streaming_val > 127 else 1024 * 1024,
            compression_chunk=1 << mv[14],
            dtype_code=mv[15],
            original_len=int.from_bytes(mv[16:24], "little"),
            total_len=int.from_bytes(mv[24:32], "little"),
            version=(mv[2], mv[3], mv[4]),
        )
        consumed = HEADER_LEN
        if hdr.input_format in formats_with_shape:
            shape, ext = unpack_shape(mv[HEADER_LEN:])
            hdr.shape = shape
            consumed += ext
        return hdr, consumed


def walk_frames(buf):
    """Iterate (offset, frame_length) over a stream of concatenated frames.

    Mirrors the reference streaming reader's hop-by-total-length walk
    (zipnn/zipnn.py:977-992).  ``frame_length`` includes the 32-byte header.
    """
    mv = memoryview(buf)
    offset = 0
    n = len(mv)
    while offset < n:
        if bytes(mv[offset : offset + 2]) != MAGIC:
            raise ValueError(f"Bad frame magic at offset {offset}")
        total = int.from_bytes(mv[offset + 24 : offset + 32], "little")
        if total <= 0:
            raise ValueError(f"Corrupt frame length {total} at offset {offset}")
        yield offset, total
        offset += total


def describe(buf_or_path) -> dict:
    """Human-readable header dump, mirroring ``ZipNN.metadata``
    (zipnn/zipnn.py:497-553)."""
    from .enums import EnumFormat, EnumLossy, EnumMethod  # noqa: PLC0415

    if isinstance(buf_or_path, str):
        with open(buf_or_path, "rb") as f:
            head = f.read(4096)
    else:
        head = bytes(memoryview(buf_or_path)[:4096])
    hdr, consumed = Header.from_bytes(head)

    def _enum_name(enum_cls, value):
        try:
            return enum_cls(value).name
        except ValueError:
            return "UNKNOWN"

    from . import dtypes  # noqa: PLC0415

    out = {
        "zipnn version": ".".join(str(v) for v in hdr.version),
        "byte_reorder": hdr.byte_reorder,
        "bit_reorder": hdr.bit_reorder,
        "method": _enum_name(EnumMethod, hdr.method),
        "input_format": _enum_name(EnumFormat, hdr.input_format),
        "delta_compressed_type": {0: 0, 1: "byte", 2: "file"}.get(hdr.delta_mode, 0),
        "lossy_compressed_type": _enum_name(EnumLossy, hdr.lossy_type),
        "lossy_compressed_factor": hdr.lossy_factor,
        "lossy_is_int": hdr.lossy_is_int,
        "is_streaming": hdr.is_streaming,
        "compression_chunk": f"{hdr.compression_chunk} Bytes",
        "dtype": dtypes.from_code(hdr.dtype_code).name.upper(),
        "original_len": f"{hdr.original_len} Bytes",
    }
    if hdr.shape is not None:
        out["shape_bytes"] = hdr.shape
        out["shape_size"] = consumed - HEADER_LEN
    return out
