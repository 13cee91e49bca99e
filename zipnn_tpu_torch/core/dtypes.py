"""Dtype registry for the ``.znn`` container.

The integer ``code`` for every dtype is format-bearing (header byte 15) and
matches the reference registry (zipnn/util_torch.py:176-234) exactly.  Torch
and JAX dtype objects are resolved lazily so that importing this package does
not force either framework into the process.

Grouping dispatch (``grouping_for_code``) reproduces the reference dispatch
table (zipnn/zipnn.py:779-835): which byte-plane split, how many planes, and
whether the sign bit is rotated out of the exponent byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class DtypeInfo:
    name: str
    code: int
    numpy_name: Optional[str]  # numpy dtype name, if representable
    torch_name: Optional[str]  # torch dtype attribute name, if representable
    jax_name: Optional[str]  # jax.numpy dtype name, if representable
    itemsize: int  # bytes per element (0 = unknown/unsupported)
    is_float: bool


_REGISTRY = [
    #          name               code  numpy         torch             jax            size float
    DtypeInfo("none", 0, None, None, None, 0, False),
    DtypeInfo("float32", 1, "float32", "float32", "float32", 4, True),
    DtypeInfo("float", 2, "float32", "float32", "float32", 4, True),
    DtypeInfo("float64", 3, "float64", "float64", "float64", 8, True),
    DtypeInfo("float16", 4, "float16", "float16", "float16", 2, True),
    DtypeInfo("half", 5, "float16", "float16", "float16", 2, True),
    DtypeInfo("bfloat16", 6, None, "bfloat16", "bfloat16", 2, True),
    DtypeInfo("complex32", 7, None, "complex32", None, 4, False),
    DtypeInfo("chalf", 8, None, "complex32", None, 4, False),
    DtypeInfo("complex64", 9, "complex64", "complex64", "complex64", 8, False),
    DtypeInfo("cfloat", 10, "complex64", "complex64", "complex64", 8, False),
    DtypeInfo("complex128", 11, "complex128", "complex128", "complex128", 16, False),
    DtypeInfo("cdouble", 12, "complex128", "complex128", "complex128", 16, False),
    DtypeInfo("uint8", 13, "uint8", "uint8", "uint8", 1, False),
    DtypeInfo("uint16", 14, "uint16", "uint16", "uint16", 2, False),
    DtypeInfo("uint32", 15, "uint32", "uint32", "uint32", 4, False),
    DtypeInfo("uint64", 16, "uint64", "uint64", "uint64", 8, False),
    DtypeInfo("int8", 17, "int8", "int8", "int8", 1, False),
    DtypeInfo("int16", 18, "int16", "int16", "int16", 2, False),
    DtypeInfo("short", 19, "int16", "int16", "int16", 2, False),
    DtypeInfo("int32", 20, "int32", "int32", "int32", 4, False),
    DtypeInfo("int", 21, "int32", "int32", "int32", 4, False),
    DtypeInfo("int64", 22, "int64", "int64", "int64", 8, False),
    DtypeInfo("long", 23, "int64", "int64", "int64", 8, False),
    DtypeInfo("bool", 24, "bool", "bool", "bool", 1, False),
    DtypeInfo("quint8", 25, None, "quint8", None, 1, False),
    DtypeInfo("qint8", 26, None, "qint8", None, 1, False),
    DtypeInfo("qint32", 27, None, "qint32", None, 4, False),
    DtypeInfo("quint4x2", 28, None, "quint4x2", None, 1, False),
    DtypeInfo("float8_e4m3fn", 29, None, "float8_e4m3fn", "float8_e4m3fn", 1, True),
    DtypeInfo("float8_e5m2", 30, None, "float8_e5m2", "float8_e5m2", 1, True),
]

_BY_NAME = {d.name: d for d in _REGISTRY}
_BY_CODE = {d.code: d for d in _REGISTRY}


def from_name(name: str) -> DtypeInfo:
    info = _BY_NAME.get(str(name).lower())
    if info is None:
        return _BY_NAME["none"]
    return info


def from_code(code: int) -> DtypeInfo:
    info = _BY_CODE.get(int(code))
    if info is None:
        raise ValueError(f"Unknown ZipNN dtype code {code}")
    return info


def from_any(dtype) -> DtypeInfo:
    """Resolve a DtypeInfo from a string / numpy / torch / jax dtype object."""
    if isinstance(dtype, DtypeInfo):
        return dtype
    if isinstance(dtype, str):
        return from_name(dtype)
    # torch.dtype objects stringify as "torch.bfloat16"
    s = str(dtype)
    if s.startswith("torch."):
        return from_name(s[len("torch."):])
    # numpy / jax dtypes stringify as their plain name ("float32", "bfloat16")
    try:
        return from_name(np.dtype(dtype).name)
    except TypeError:
        return from_name(s)


def torch_dtype(info: DtypeInfo):
    import torch  # noqa: PLC0415 - lazy by design

    if info.torch_name is None:
        raise ValueError(f"dtype {info.name} has no torch equivalent")
    return getattr(torch, info.torch_name)


def numpy_dtype(info: DtypeInfo):
    if info.numpy_name is None:
        raise ValueError(f"dtype {info.name} has no numpy equivalent")
    return np.dtype(info.numpy_name)


@dataclass(frozen=True)
class Grouping:
    """Byte-plane grouping parameters for one dtype.

    Mirrors the dispatch in the reference compress path
    (zipnn/zipnn.py:788-835): ``num_buf`` planes, the format-bearing
    ``byte_reorder`` mode byte, and whether the sign-bit rotation applies.
    """

    num_buf: int
    byte_reorder: int
    bit_reorder: int
    dtype_size: int  # bits


_FP8_CODES = (29, 30)
_FP32_CODES = (1, 2)
_BF16_CODE = 6
_FP16_CODES = (4, 5)


def grouping_for_code(code: int) -> Grouping:
    """Reference-exact grouping decision per dtype code."""
    if code in _FP8_CODES:
        return Grouping(num_buf=1, byte_reorder=10, bit_reorder=1, dtype_size=8)
    if code in _FP32_CODES:
        return Grouping(num_buf=4, byte_reorder=220, bit_reorder=1, dtype_size=32)
    if code == _BF16_CODE:
        return Grouping(num_buf=2, byte_reorder=10, bit_reorder=1, dtype_size=16)
    if code in _FP16_CODES:
        # fp16's exponent straddles the byte boundary; the reference keeps the
        # raw byte split with no sign-bit rotation (zipnn.py:809-813).
        return Grouping(num_buf=2, byte_reorder=10, bit_reorder=0, dtype_size=16)
    raise ValueError(
        f"Byte-grouped compression supports float32/bfloat16/float16/fp8 dtypes, got code {code}"
    )


def groups_for_decompress(code: int) -> int:
    """Number of byte planes expected on decompress (zipnn.py:1097-1123)."""
    if code in _FP8_CODES:
        return 1
    if code in _FP32_CODES:
        return 4
    if code == _BF16_CODE or code in _FP16_CODES:
        return 2
    raise ValueError(f"Unsupported dtype code for decompress: {code}")
