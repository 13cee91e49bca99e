"""Plane assembly of decoded chunks: the CUDA kernel's wrapper and its
plain PyTorch version.

The counterpart of the JAX package's ``ops/pallas_combine.py``.  Each
(chunk, plane) cell is described by a kind and a source:

* kind 0, stored: ``src`` is the cell's byte offset in the payload;
* kind 1, RLE: ``src`` is the repeated byte;
* kind 2, Huffman: ``src`` is the cell's row in the symbol buffer that
  ``huf_pc.huf_pc_decode`` wrote (row stride ``hsym_row`` bytes).

The planes are then combined as ``byte_group.combine`` does (mode 10
interleave of 2 planes, modes 1/8 zero-fill, mode 220 interleave of 4
planes, the bf16 or fp32 sign rotation reverted on the whole words of
each chunk).  Chunks are ``chunk_size`` bytes except a
ragged last one; the output is written as words, so up to 3 bytes past
``total_bytes`` are written (as zero).  Chunks of 1 or 2 bytes (whose
cells are stored or RLE) start off word boundaries; the kernel writes
them byte by byte.
"""
from __future__ import annotations

import torch

from . import kernels, transforms
from .byte_group import plane_lengths


def combine_cells(
    payload: torch.Tensor,
    hsym: torch.Tensor,
    kinds: torch.Tensor,
    srcs: torch.Tensor,
    hsym_row: int,
    chunk_size: int,
    total_bytes: int,
    num_buf: int,
    byte_reorder: int,
    bit_reorder: int,
    out: torch.Tensor,
) -> torch.Tensor:
    """Assemble ``ceil(total_bytes / chunk_size)`` chunks into ``out``
    (uint8, at least ``total_bytes`` rounded up to 4 bytes, 4-byte
    aligned).  Returns ``out``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    dev = out.device
    n_chunks = -(-total_bytes // chunk_size)
    if num_buf not in (1, 2, 4) or (num_buf == 4 and byte_reorder != 220):
        raise ValueError(
            f"combine_cells: {num_buf} planes in mode {byte_reorder} not supported"
        )
    if chunk_size < 1:
        raise ValueError(f"combine_cells: chunk_size {chunk_size} < 1")
    for name, t, dt in (
        ("payload", payload, torch.uint8), ("hsym", hsym, torch.uint8),
        ("kinds", kinds, torch.int32), ("srcs", srcs, torch.int64),
        ("out", out, torch.uint8),
    ):
        if t.device != dev:
            raise ValueError(f"combine_cells: {name} on {t.device}, out on {dev}")
        if t.dtype != dt:
            raise TypeError(f"combine_cells: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"combine_cells: {name} must be contiguous")
    if kinds.shape != (n_chunks * num_buf,) or srcs.shape != kinds.shape:
        raise ValueError(
            f"combine_cells: kinds/srcs must be [{n_chunks * num_buf}]"
        )
    if out.numel() < -(-total_bytes // 4) * 4 or out.data_ptr() % 4:
        raise ValueError("combine_cells: out too small or not 4-byte aligned")
    if dev.type == "cpu":
        return combine_cells_plain(
            payload, hsym, kinds, srcs, hsym_row, chunk_size, total_bytes,
            num_buf, byte_reorder, bit_reorder, out,
        )
    if dev.type != "cuda":
        raise ValueError(f"combine_cells: unsupported device {dev}")
    if total_bytes:
        kernels.launch(
            "combine_cells", dev,
            payload.data_ptr(), hsym.data_ptr(), kinds.data_ptr(),
            srcs.data_ptr(), int(hsym_row), int(chunk_size), int(total_bytes),
            int(num_buf), int(byte_reorder), int(bit_reorder), out.data_ptr(),
        )
    return out


def _cell_bytes(payload, hsym, kind: int, src: int, hsym_row: int, n: int):
    if kind == 0:
        return payload[src : src + n]
    if kind == 1:
        return torch.full((n,), src & 0xFF, dtype=torch.uint8, device=payload.device)
    return hsym[src * hsym_row : src * hsym_row + n]


def combine_cells_plain(
    payload, hsym, kinds, srcs, hsym_row: int, chunk_size: int,
    total_bytes: int, num_buf: int, byte_reorder: int, bit_reorder: int, out,
):
    """Plain PyTorch version: per chunk, fill the planes, then combine them
    with ``transforms.combine_2`` (mode 10), ``transforms.combine_4`` (mode
    220) or a strided copy (modes 1/8) and revert the rotation on the
    chunk's whole words."""
    n_chunks = -(-total_bytes // chunk_size)
    kinds_h = kinds.cpu().tolist()
    srcs_h = srcs.cpu().tolist()
    end = -(-total_bytes // 4) * 4
    out[total_bytes:end] = 0
    for c in range(n_chunks):
        clen = min(chunk_size, total_bytes - c * chunk_size)
        lens = plane_lengths(clen, num_buf, byte_reorder)
        planes = [
            _cell_bytes(payload, hsym, kinds_h[c * num_buf + b],
                        srcs_h[c * num_buf + b], hsym_row, lens[b])
            for b in range(num_buf)
        ]
        dst = out[c * chunk_size : c * chunk_size + clen]
        if num_buf == 1:
            dst.copy_(planes[0])
            continue
        if byte_reorder in (10, 220):
            # the word combine on the planes zero-padded to whole words
            # (plane 0 is the longest); the rotation is reverted below, on
            # the chunk's whole words only
            pw = torch.zeros((num_buf, -(-lens[0] // 4) * 4), dtype=torch.uint8,
                             device=dst.device)
            for b in range(num_buf):
                pw[b, : lens[b]] = planes[b]
            comb = transforms.combine_2 if num_buf == 2 else transforms.combine_4
            dst.copy_(comb(pw.view(torch.int32), 0).view(torch.uint8)[:clen])
        else:
            keep = 0 if byte_reorder == 1 else 1
            dst.zero_()
            dst[keep::2][: lens[0]] = planes[0]
        if bit_reorder and clen >= 4:
            nw = clen // 4
            words = dst[: 4 * nw].clone().view(torch.int32)  # dst may be off a word boundary
            revert = transforms.revert_sign_16 if num_buf == 2 else transforms.revert_sign_32
            dst[: 4 * nw] = revert(words).view(torch.uint8)
    return out
