"""The safetensors file layout, written and read with no ``safetensors``
package.

A file is an 8-byte little-endian header length, a JSON header, then the
tensors' bytes.  The header maps each tensor name to ``{"dtype", "shape",
"data_offsets"}`` (offsets into the data region) and may hold a
``"__metadata__"`` map of strings.  :func:`write` and :func:`to_bytes` lay
a file out exactly as ``safetensors.torch.save_file`` does (version 0.8):

* the data is ordered by dtype, in :data:`ORDER` (widest first), and by
  name within a dtype;
* the header is compact JSON (non-ASCII characters written as UTF-8),
  ``"__metadata__"`` first when metadata is given (``{}`` included), then
  the tensors in data order, each as ``dtype``, ``shape``,
  ``data_offsets``;
* the header is padded with spaces so that the data starts on a multiple
  of 8 bytes.

The package keeps ``__metadata__`` in a hash map, so a file it writes with
two or more metadata keys has them in no fixed order; this module writes
them in the order of the caller's dict.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

METADATA = "__metadata__"

# safetensors dtype name -> torch dtype
DTYPES: Dict[str, torch.dtype] = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "U16": torch.uint16, "U32": torch.uint32,
    "U64": torch.uint64, "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
NAMES: Dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}
# the package's data order of the dtypes
ORDER: Tuple[str, ...] = ("U64", "I64", "F64", "F32", "U32", "I32", "BF16", "F16", "U16",
                          "I16", "F8_E4M3", "F8_E5M2", "I8", "U8", "BOOL")
_RANK = {name: i for i, name in enumerate(ORDER)}


def dtype_name(dtype: torch.dtype) -> str:
    """The safetensors name of a torch dtype (``torch.bfloat16`` ->
    ``"BF16"``)."""
    try:
        return NAMES[dtype]
    except KeyError:
        raise ValueError(f"safetensors has no dtype for {dtype}") from None


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes in memory order, as a host uint8 array."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def header_bytes(entries: Iterable[Tuple[str, str, List[int], int]],
                 metadata: Optional[Dict[str, str]] = None) -> bytes:
    """The 8-byte length and the padded JSON header of a file whose
    tensors ``(name, dtype name, shape, nbytes)`` lie back to back in the
    order given, for a writer that places the data itself."""
    header: dict = {} if metadata is None else {METADATA: metadata}
    off = 0
    for name, dtype, shape, nbytes in entries:
        header[name] = {"dtype": dtype, "shape": [int(s) for s in shape],
                        "data_offsets": [off, off + int(nbytes)]}
        off += int(nbytes)
    text = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    return struct.pack("<Q", len(text)) + text


def _ordered(tensors: Dict[str, torch.Tensor]):
    """(header, the tensors' byte arrays) in the package's data order."""
    order = sorted(tensors, key=lambda n: (_RANK[dtype_name(tensors[n].dtype)], n))
    arrays = [_host_bytes(tensors[n]) for n in order]
    entries = [(n, dtype_name(tensors[n].dtype), list(tensors[n].shape), a.nbytes)
               for n, a in zip(order, arrays)]
    return entries, arrays


def to_bytes(tensors: Dict[str, torch.Tensor],
             metadata: Optional[Dict[str, str]] = None) -> bytes:
    """The safetensors file of ``tensors`` as ``bytes``
    (``safetensors.torch.save``'s output)."""
    entries, arrays = _ordered(tensors)
    return header_bytes(entries, metadata) + b"".join(a.tobytes() for a in arrays)


def write(path, tensors: Dict[str, torch.Tensor],
          metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (on any device) to ``path`` as
    ``safetensors.torch.save_file`` does."""
    entries, arrays = _ordered(tensors)
    with open(path, "wb") as f:
        f.write(header_bytes(entries, metadata))
        for a in arrays:
            f.write(a)


def read_header(src) -> Tuple[dict, int]:
    """(the parsed JSON header, the data region's offset) of a file: a
    path, or the file's bytes (any buffer)."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{src}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            text = f.read(n)
    else:
        mv = memoryview(src).cast("B")
        if len(mv) < 8:
            raise ValueError("not a safetensors buffer (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", mv[:8])
        text = bytes(mv[8 : 8 + n])
    if len(text) != n:
        raise ValueError(f"safetensors header of {n} bytes runs past the end of the data")
    return json.loads(text), 8 + n


def read_range(src, entry: dict, data_start: int) -> bytes:
    """The stored bytes of one tensor (its header ``entry``) of a file:
    one seek and read of a path, or a slice of a buffer."""
    lo, hi = entry["data_offsets"]
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            f.seek(data_start + lo)
            raw = f.read(hi - lo)
    else:
        raw = bytes(memoryview(src).cast("B")[data_start + lo : data_start + hi])
    if len(raw) != hi - lo:
        raise ValueError(f"tensor bytes [{lo}, {hi}) run past the end of the data")
    return raw


def as_tensor(raw, entry: dict) -> torch.Tensor:
    """Stored bytes as a host tensor of the entry's dtype and shape."""
    dtype = DTYPES[entry["dtype"]]
    if len(raw) == 0:
        return torch.empty(entry["shape"], dtype=dtype)
    flat = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy())
    return flat.view(dtype).reshape(entry["shape"])


def read(src) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, str]]]:
    """({name: host tensor} in header order, metadata or None) of a whole
    file: a path or a buffer."""
    header, start = read_header(src)
    metadata = header.pop(METADATA, None)
    return {n: as_tensor(read_range(src, e, start), e) for n, e in header.items()}, metadata
