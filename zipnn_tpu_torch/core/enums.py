"""Enums mirroring the ZipNN container header fields.

Values are format-bearing: they are written into byte 7 (method) and byte 8
(input format) of the 32-byte ``.znn`` header and must match the reference
(zipnn/util_header.py:5-44) bit-for-bit for cross-compatibility.
"""
from __future__ import annotations

from enum import Enum


class _StrLookupEnum(Enum):
    """Enum that also accepts case-insensitive member-name strings."""

    @classmethod
    def _missing_(cls, value):
        if isinstance(value, str):
            value = value.upper()
            if value in cls.__members__:
                return cls.__members__[value]
        return None


class EnumMethod(_StrLookupEnum):
    """Entropy-coding method recorded in header byte 7."""

    AUTO = 0
    HUFFMAN = 1
    ZSTD = 2
    LZ4 = 3
    SNAPPY = 4


class EnumFormat(_StrLookupEnum):
    """Input/output marshalling format recorded in header byte 8.

    ``JAX`` is a TPU-native extension of this framework (not present in the
    reference); files written with it are not readable by the reference
    library, all other codes are cross-compatible.
    """

    BYTE = 1
    TORCH = 2
    NUMPY = 3
    FILE = 4
    JAX = 5


class EnumLossy(_StrLookupEnum):
    """Lossy pre-transform recorded in header byte 10."""

    NONE = 0
    INTEGER = 1
    UNSIGN = 2
