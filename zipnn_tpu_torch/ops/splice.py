"""Cells into the container's layout on the card: the CUDA kernel's
wrapper and its plain PyTorch version.

The JAX package assembles a container on the host
(``ops/jax_codec.py`` ``_assemble``, and the native core's splice); it has
no device kernel for this step.  The port's encoder writes each batch's
cells on the card (``csrc/splice.cu``), at the offsets of the payload's
plane-major layout, so the batch's bytes leave the card once and land in
place (``ops/encode.py``).

A batch's cells are rows of ``FIELDS`` int64 (host memory, 32 bytes a
cell), read from ``groups``, a list of 2-D contiguous device tensors whose
rows are the sources: the split planes (a row a cell) and the Huffman
encoder's output (a row a stream).

* ``dst``: the cell's byte offset in ``out``;
* ``info`` (:func:`info`): its stored ``size``, its ``kind`` (``RAW``,
  ``RLE`` or ``HUF``), the ``group`` it reads and a Huffman cell's header
  length ``hlen``;
* ``src`` (:func:`src`): the source ``row`` in the group, and a Huffman
  cell's weight header offset ``hoff`` in ``hpool``.  A raw or RLE cell is
  the first ``size`` bytes of its row (an RLE cell's one byte is its
  plane's first byte); a Huffman cell's stream ``s`` is the first ``sb_s``
  bytes of row ``row + s``;
* ``sb``: a Huffman cell's four stream lengths, 16 bits each.  The cell
  is its header (``hlen`` bytes of ``hpool`` from ``hoff``), the jump table
  (``sb_0``, ``sb_1``, ``sb_2`` as little-endian uint16) and its streams.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import kernels

RAW, RLE, HUF = 0, 1, 2
FIELDS = 4
DST, INFO, SRC, SB = range(FIELDS)
_M32 = 0xFFFFFFFF


def info(size, kind, group=0, hlen=0):
    """The ``info`` field: ``size | kind << 32 | group << 40 | hlen << 48``
    (scalars or arrays)."""
    return (np.asarray(size, np.int64) | np.asarray(kind, np.int64) << 32
            | np.asarray(group, np.int64) << 40 | np.asarray(hlen, np.int64) << 48)


def src(row, hoff=0):
    """The ``src`` field: ``row | hoff << 32``."""
    return np.asarray(row, np.int64) | np.asarray(hoff, np.int64) << 32


def _unpack(cells: np.ndarray):
    """(dst, size, kind, group, hlen, row, hoff, [n, 4] stream lengths)."""
    i, r = cells[:, INFO], cells[:, SRC]
    return (cells[:, DST], i & _M32, (i >> 32) & 0xFF, (i >> 40) & 0xFF, (i >> 48) & 0xFFFF,
            r & _M32, (r >> 32) & _M32, _stream_lens(cells[:, SB]))


def pack_sb(sb: np.ndarray) -> np.ndarray:
    """[m, 4] stream lengths (each below 2^16) -> [m] int64 ``sb``."""
    sb = np.asarray(sb, np.int64)
    return sb[:, 0] | sb[:, 1] << 16 | sb[:, 2] << 32 | sb[:, 3] << 48


def _stream_lens(sb: np.ndarray) -> np.ndarray:
    return (sb[:, None] >> (16 * np.arange(4))) & 0xFFFF


def _row_bytes(t: torch.Tensor) -> int:
    return t.shape[1] * t.element_size()


def check_cells(out: torch.Tensor, cells: np.ndarray, groups: Sequence[torch.Tensor],
                hpool: torch.Tensor) -> None:
    """Raise ValueError for a cell that reads outside its source row, the
    header pool or its group, or writes outside ``out``."""
    if out.dtype != torch.uint8 or out.dim() != 1 or not out.is_contiguous():
        raise ValueError("splice_cells: out must be a contiguous 1-D uint8 tensor")
    if hpool.dtype != torch.uint8 or hpool.dim() != 1:
        raise ValueError("splice_cells: hpool must be a 1-D uint8 tensor")
    if not 0 < len(groups) <= 256:
        raise ValueError(f"splice_cells: {len(groups)} groups, want 1 to 256")
    for t in (*groups, hpool):
        if t.device != out.device:
            raise ValueError(f"splice_cells: a source on {t.device}, out on {out.device}")
        if not t.is_contiguous():
            raise ValueError("splice_cells: sources must be contiguous")
    for g in groups:
        if g.dim() != 2:
            raise ValueError("splice_cells: every group must be 2-D (a source per row)")
    if cells.dtype != np.int64 or cells.ndim != 2 or cells.shape[1] != FIELDS:
        raise ValueError(f"splice_cells: cells must be int64 [n, {FIELDS}]")
    if not cells.shape[0]:
        return
    dst, size, kind, group, hlen, row, hoff, lens = _unpack(cells)
    rows = np.asarray([g.shape[0] for g in groups], np.int64)
    width = np.asarray([_row_bytes(g) for g in groups], np.int64)
    bad = (kind > HUF) | (group >= len(groups)) | (dst < 0) | (dst + size > out.numel())
    grp = np.minimum(group, len(groups) - 1)
    huf = kind == HUF
    bad |= row + np.where(huf, 3, 0) >= rows[grp]
    bad |= ~huf & ((size > width[grp]) | ((kind == RLE) & (size != 1)))
    bad |= huf & ((lens > width[grp][:, None]).any(axis=1)
                  | (hlen + 6 + lens.sum(axis=1) != size) | (hoff + hlen > hpool.numel()))
    if bad.any():
        raise ValueError(f"splice_cells: cell {int(np.argmax(bad))} reads or writes outside "
                         f"its sources or out")


def splice_cells(out: torch.Tensor, cells: np.ndarray, groups: Sequence[torch.Tensor],
                 hpool: torch.Tensor) -> None:
    """Write every cell of ``cells`` (host int64 [n, ``FIELDS``]) into
    ``out`` from ``groups`` and ``hpool`` (the module docstring says how),
    after :func:`check_cells`.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (the cells go up from pinned memory, with the
    groups' addresses and row strides in front).
    """
    cells = np.ascontiguousarray(cells, dtype=np.int64).reshape(-1, FIELDS)
    check_cells(out, cells, groups, hpool)
    dev = out.device
    if dev.type == "cpu":
        splice_cells_plain(out, cells, groups, hpool)
        return
    if dev.type != "cuda":
        raise ValueError(f"splice_cells: unsupported device {dev}")
    n = cells.shape[0]
    if not n:
        return
    head = np.asarray([g.data_ptr() for g in groups] + [_row_bytes(g) for g in groups],
                      np.int64)
    desc = torch.from_numpy(np.concatenate([head, cells.reshape(-1)])).pin_memory()
    desc = desc.to(dev, non_blocking=True)
    kernels.launch("splice_cells", dev, out.data_ptr(), desc.data_ptr(), len(groups), n,
                   hpool.data_ptr())


def splice_cells_plain(out: torch.Tensor, cells: np.ndarray, groups: Sequence[torch.Tensor],
                       hpool: torch.Tensor) -> None:
    """Plain PyTorch version of :func:`splice_cells`: each piece of each
    cell by one slice copy."""
    srcs = [g.contiguous().view(torch.uint8).reshape(g.shape[0], -1) for g in groups]
    for dst, size, kind, group, hlen, row, hoff, lens in zip(
            *(a.tolist() for a in _unpack(cells))):
        rows = srcs[group]
        if kind != HUF:
            out[dst : dst + size] = rows[row, :size]
            continue
        out[dst : dst + hlen] = hpool[hoff : hoff + hlen]
        jumps = torch.from_numpy(np.asarray(lens[:3], "<u2").view(np.uint8))
        out[dst + hlen : dst + hlen + 6] = jumps.to(out.device)
        o = dst + hlen + 6
        for s, n in enumerate(lens):
            out[o : o + n] = rows[row + s, :n]
            o += n


def host_cells(cells: np.ndarray, groups: Sequence[torch.Tensor], hpool: torch.Tensor) -> dict:
    """The same cells as arguments of the native core's splice
    (``native.splice_cells``, which reads them from host memory), but
    ``out``: the plain Python route the card's splice replaced, for
    holding the two against each other."""
    srcs = [g.cpu().contiguous().view(torch.uint8).reshape(g.shape[0], -1).numpy()
            for g in groups]
    dst, size, kind, group, hlen, row, hoff, lens = _unpack(cells)
    n = cells.shape[0]
    parts, boff, pos = [], np.zeros(n, np.int64), 0
    rle = np.zeros(n, np.uint8)
    for i in range(n):
        rows, r = srcs[group[i]], row[i]
        boff[i] = pos
        if kind[i] == HUF:
            piece = np.concatenate([rows[r + s, : lens[i, s]] for s in range(4)])
        else:
            piece = rows[r, : size[i]]
            rle[i] = piece[0] if size[i] else 0
        parts.append(piece)
        pos += piece.size
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return dict(starts=dst.copy(), kinds=kind.astype(np.uint8), sizes=size.copy(),
                rle_vals=rle, hids=np.arange(n, dtype=np.int64), hpool=hpool.cpu().numpy(),
                hoffs=hoff.copy(), hlens=hlen.copy(), jumps=lens[:, :3].astype(np.uint16),
                boffs=boff, blob=blob)
