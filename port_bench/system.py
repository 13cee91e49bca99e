"""The system under test: ``zipnn_tpu_torch``, called through its public
serving API.  The only module of the benchmark that imports the program.

``Port`` gives the drivers (``drivers/*.py``) what they call: encode a
checkpoint into containers, stage containers on the card, decode a staged
unit; ``launches`` reads the program's kernel launch counters.
"""
from __future__ import annotations

from typing import List

import torch


class Port:
    def __init__(self, device):
        from zipnn_tpu_torch import ZipNN  # noqa: PLC0415
        from zipnn_tpu_torch.io import serving  # noqa: PLC0415
        from zipnn_tpu_torch.ops import kernels  # noqa: PLC0415

        self.device = torch.device(device)
        self._zipnn = ZipNN
        self._serving = serving
        self._kernels = kernels
        self._dec = serving.ShardDecoder(to_device=True, device=self.device)

    def launches(self) -> int:
        return sum(self._kernels.launches.values())

    def encode_all(self, tensors, chunk: int, huffman_table: str) -> List[bytes]:
        """One container a tensor, each an owned ``bytes``, in the profile
        the configuration states."""
        codec = self._zipnn(input_format="torch", engine="cuda", device=self.device,
                            huffman_table=huffman_table, compression_chunk=chunk)
        enc = self._serving.ShardEncoder(codec, pool_staging=True, device=self.device)
        return enc.compress_all(tensors)

    def stage(self, containers):
        """Plan and upload ``containers``; a handle for :meth:`decode`."""
        return self._dec.stack([self._dec.stage(c) for c in containers])

    def decode(self, staged) -> List[torch.Tensor]:
        """A staged unit's tensors (uint8, on the card), checked by one
        fetch."""
        return self._dec.decompress_stacked(staged)
