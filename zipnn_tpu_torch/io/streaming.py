"""Streaming safetensors reader with transparent ``.znn`` decompression.

The port of the JAX package's ``io/streaming.py``.  safetensors layout:
``[8-byte little-endian header length][JSON header][data]``, the header
mapping tensor name -> {dtype, shape, data_offsets}.  The reader parses
the file itself (no ``safetensors`` import) and seeks straight to a
tensor's byte range instead of mapping the whole file, so each host of a
multi-host load reads only its share (:func:`partition_names`).

Tensors come back as torch tensors (bf16 and fp8 as torch dtypes, no
``ml_dtypes``).  Compressed tensors (per-tensor containers under the
``znn_compressed_vectors`` metadata key, reference
zipnn/util_safetensors.py:9) decode on ``decode_device``, the card unless
the caller passes ``decode_device="cpu"``; ``get_tensor`` and
``load_shard`` leave each result there or move it to the ``device`` the
caller asks for.  ``load_shard`` decodes its compressed tensors back to
back through ``io.serving.ShardDecoder.decompress_iter``.
"""
from __future__ import annotations

import json
from struct import unpack
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .serving import ShardDecoder

METADATA_KEY = "znn_compressed_vectors"
# safetensors dtype -> torch dtype attribute
_ST_DTYPES = {
    "F64": "float64", "F32": "float32", "F16": "float16", "BF16": "bfloat16",
    "F8_E4M3": "float8_e4m3fn", "F8_E5M2": "float8_e5m2", "I64": "int64",
    "I32": "int32", "I16": "int16", "I8": "int8", "U8": "uint8", "U16": "uint16",
    "U32": "uint32", "U64": "uint64", "BOOL": "bool",
}


def partition_names(
    entries: Sequence[Tuple[str, int]], n_hosts: int, host_id: int
) -> List[str]:
    """Size-balanced partition of (name, nbytes) entries across hosts.

    Greedy largest-first binning: deterministic given the same inputs, so
    every host computes the same global assignment without communication.
    """
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} out of range for {n_hosts} hosts")
    loads = [0] * n_hosts
    owner: Dict[str, int] = {}
    for name, size in sorted(entries, key=lambda e: (-e[1], e[0])):
        h = loads.index(min(loads))
        owner[name] = h
        loads[h] += size
    return [n for n, _ in entries if owner[n] == host_id]


def tensor_from_flat(flat: torch.Tensor, info: Dict[str, str]) -> torch.Tensor:
    """A decoded container's flat uint8 bytes as the tensor that its
    ``znn_compressed_vectors`` entry describes (``{"dtype": "bfloat16",
    "shape": "[4096, 4096]"}``), on ``flat``'s device, no copy."""
    return flat.view(getattr(torch, info["dtype"])).reshape(json.loads(info["shape"]))


class SafetensorsStreamReader:
    """Range-reading safetensors loader with transparent znn decompression
    on ``decode_device``."""

    def __init__(self, path: str, decode_device="cuda"):
        self.path = path
        self.decode_device = torch.device(decode_device)
        with open(path, "rb") as f:
            (hlen,) = unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen))
        self._data_start = 8 + hlen
        self.metadata: Dict[str, str] = header.pop("__metadata__", {}) or {}
        self._tensors = header
        comp = self.metadata.get(METADATA_KEY)
        self.compressed: Dict[str, Dict] = json.loads(comp) if comp else {}

    # -- introspection ---------------------------------------------------
    def keys(self) -> List[str]:
        return list(self._tensors.keys())

    def nbytes(self, name: str) -> int:
        lo, hi = self._tensors[name]["data_offsets"]
        return hi - lo

    def entries(self) -> List[Tuple[str, int]]:
        return [(n, self.nbytes(n)) for n in self.keys()]

    def shard_names(self, n_hosts: int, host_id: int) -> List[str]:
        """The tensor names this host should read (deterministic across
        hosts: no communication needed)."""
        return partition_names(self.entries(), n_hosts, host_id)

    # -- range reads -----------------------------------------------------
    def read_bytes(self, name: str) -> bytes:
        info = self._tensors[name]
        lo, hi = info["data_offsets"]
        with open(self.path, "rb") as f:
            f.seek(self._data_start + lo)
            return f.read(hi - lo)

    def _stored(self, name: str) -> torch.Tensor:
        """The stored bytes as a host tensor of the stored dtype and shape."""
        info = self._tensors[name]
        raw = torch.from_numpy(np.frombuffer(self.read_bytes(name), dtype=np.uint8).copy())
        return raw.view(getattr(torch, _ST_DTYPES[info["dtype"]])).reshape(info["shape"])

    def _decoded(self, names: List[str]) -> Iterator[torch.Tensor]:
        """The compressed tensors ``names`` decoded on ``decode_device``
        back to back (``ShardDecoder.decompress_iter``), in order."""
        dec = ShardDecoder(to_device=True, device=self.decode_device)
        flats = dec.decompress_iter(self.read_bytes(n) for n in names)
        return (tensor_from_flat(f, self.compressed[n]) for n, f in zip(names, flats))

    def _load(self, names: List[str], device) -> Dict[str, torch.Tensor]:
        comp = [n for n in names if n in self.compressed]
        decoded = dict(zip(comp, self._decoded(comp)))
        return {n: (decoded[n] if n in decoded else self._stored(n)).to(device)
                for n in names}

    def get_tensor(self, name: str, device="cpu") -> torch.Tensor:
        """Read one tensor onto ``device``, decoding it on
        ``decode_device`` if it is compressed."""
        return self._load([name], device)[name]

    def load_shard(
        self, n_hosts: int = 1, host_id: int = 0, device="cpu"
    ) -> Dict[str, torch.Tensor]:
        """Read this host's partition of the file (byte-range reads only)
        onto ``device``."""
        return self._load(self.shard_names(n_hosts, host_id), device)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
