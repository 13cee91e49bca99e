"""Per-row constant scan (RLE detection) of the shared-table encode: the
CUDA kernel's wrapper and its plain PyTorch version.

The counterpart of the JAX package's ``pallas_gather.const_scan_rows``
(K8).  The encoder runs it over every (chunk, plane) row of a batch: a
row whose bytes all equal its first byte is an RLE cell, stored as that
one byte.  The kernel is ``csrc/const_scan.cu``.
"""
from __future__ import annotations

import torch

from . import kernels

_M32 = 0xFFFFFFFF


def const_scan_rows(rows: torch.Tensor) -> torch.Tensor:
    """[N, W] int32 words (little-endian bytes) -> [N] int32 flags
    ``b0 | is_const << 8``: ``b0`` is the row's first byte, ``is_const``
    whether every byte of the row equals it.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if rows.dtype != torch.int32:
        raise TypeError(f"const_scan_rows: rows must be int32, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape[1] == 0:
        raise ValueError(f"const_scan_rows: rows must be [N, W] with W > 0, "
                         f"got {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("const_scan_rows: rows must be contiguous")
    dev = rows.device
    if dev.type == "cpu":
        return const_scan_rows_plain(rows)
    if dev.type != "cuda":
        raise ValueError(f"const_scan_rows: unsupported device {dev}")
    n, w = rows.shape
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        kernels.launch("const_scan_rows", dev, rows.data_ptr(), n, w, out.data_ptr())
    return out


def const_scan_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`const_scan_rows`."""
    w = rows.to(torch.int64) & _M32
    b0 = w[:, 0] & 0xFF
    same = (w == (b0 * 0x01010101)[:, None]).all(dim=1)
    return (b0 | (same.to(torch.int64) << 8)).to(torch.int32)
