"""Per-cell byte histograms of the per-chunk encode: the CUDA kernel's
wrapper and its plain PyTorch version.

The counterpart of the JAX package's ``jax_entropy.histogram_cells`` (XLA
device code in its per-chunk encode, ``jax_codec.compress_payload``; not a
Pallas kernel).  The encoder runs it over every (chunk, plane) cell of a
batch: the counts decide each cell's RLE, raw or Huffman plan and build
its Huffman table on the host.  The kernel is ``csrc/hist.cu``.
"""
from __future__ import annotations

import torch

from . import kernels


def hist_cells(rows: torch.Tensor) -> torch.Tensor:
    """[R, W] int32 words (little-endian bytes, a cell a row) -> [R, 256]
    int32: how often each byte value occurs in each row.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if rows.dtype != torch.int32:
        raise TypeError(f"hist_cells: rows must be int32, got {rows.dtype}")
    if rows.dim() != 2:
        raise ValueError(f"hist_cells: rows must be [R, W], got {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("hist_cells: rows must be contiguous")
    if rows.shape[1] >= 1 << 29:
        raise ValueError(f"hist_cells: rows of {rows.shape[1]} words (2^29 or more)")
    dev = rows.device
    if dev.type == "cpu":
        return hist_cells_plain(rows)
    if dev.type != "cuda":
        raise ValueError(f"hist_cells: unsupported device {dev}")
    n, w = rows.shape
    out = torch.empty((n, 256), dtype=torch.int32, device=dev)
    if n:
        kernels.launch("hist_cells", dev, rows.data_ptr(), n, w, out.data_ptr())
    return out


def hist_cells_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_cells`: one ``bincount`` over
    ``row * 256 + byte``."""
    n = rows.shape[0]
    return torch.bincount(cell_byte_index(rows).reshape(-1),
                          minlength=n * 256).view(n, 256).to(torch.int32)


def cell_byte_index(rows: torch.Tensor) -> torch.Tensor:
    """[R, 4W] int64 ``row * 256 + byte`` of every byte of ``rows``."""
    n, w = rows.shape
    syms = rows.contiguous().view(torch.uint8).reshape(n, 4 * w).to(torch.int64)
    return syms + torch.arange(n, dtype=torch.int64, device=rows.device)[:, None] * 256
