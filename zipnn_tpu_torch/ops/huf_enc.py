"""Huffman encode of HUF streams: the table packing, the CUDA kernel's two
entries' wrappers and their plain PyTorch versions.

* ``huf_shared_encode``, the counterpart of the JAX package's
  ``ops/pallas_huf_enc.py`` (K7): the shared-table profile codes every
  cell of a byte plane with one table of at most 8-bit codes.
* ``huf_pc_encode`` (E), the counterpart of ``jax_entropy.encode_streams``
  (XLA device code of the per-chunk encode, not a Pallas kernel): codes of
  at most 12 bits, each cell with its own table.

The kernel (``csrc/huf_enc.cu``) encodes a shared-table stream per warp
and a per-chunk stream over ``parts_per_stream`` warps of a block (one per
lane for short streams of either, ``streams_per_warp``).  Each stream's
bytes equal ``huf.encode_stream`` on the same symbols: symbols in
descending index order, LSB-first codes, a closing sentinel bit, zero
padding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import kernels

TMAX = 8  # the longest code of a shared table
PC_TMAX = 12  # the longest code of a per-chunk table (HUF_TABLELOG_MAX)
_M32 = 0xFFFFFFFF
# a launch of streams of fewer symbols encodes one stream per lane
# (``streams_per_warp``; the crossover measured by time_kernels.py)
WARP_SYMBOLS = 512
# ``huf_pc_encode`` splits each stream over up to MAX_PARTS warps of a
# block (powers of 2; a part holds whole tiles of TILE_SYMBOLS symbols, a
# shorter stream takes one part) until the launch holds PART_WARPS warps
# (``parts_per_stream``); PARTS, when set, forces the split
TILE_SYMBOLS = 1024
MAX_PARTS = 16
PART_WARPS = 1024
PARTS: Optional[int] = None


def streams_per_warp(seg: int) -> int:
    """Streams each warp of K7 encodes: 1, a warp per stream in tiles of
    512 symbols, for streams of ``WARP_SYMBOLS`` symbols or more, else 32,
    one per lane by the serial chain.  Every stream of a launch has ``seg``
    symbols, so the host picks without looking at the data."""
    return 1 if seg >= WARP_SYMBOLS else 32


def parts_per_stream(n_streams: int, seg: int) -> int:
    """Warps each stream of a ``huf_pc_encode`` launch takes on the warp
    schedule (a power of 2 up to ``MAX_PARTS``): doubled while the launch
    holds fewer than ``PART_WARPS`` warps and each part keeps a tile of
    ``TILE_SYMBOLS`` symbols.  ``PARTS`` overrides.  The host picks from
    the stream count and length alone, without looking at the data."""
    if PARTS is not None:
        return PARTS
    tiles = -(-seg // TILE_SYMBOLS)
    p = 1
    while p < MAX_PARTS and n_streams * p < PART_WARPS and 2 * p <= tiles:
        p *= 2
    return p


def pack_etable(vals: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The kernel's 256-entry table: ``val | nb << 8`` per symbol (int16;
    ``val`` is masked to its ``nb`` bits, so a symbol without a code packs
    as 0).  Raises ValueError for a code longer than 8 bits."""
    lengths = np.asarray(lengths, dtype=np.int64)[:256]
    if int(lengths.max()) > TMAX:
        raise ValueError("shared encode table must have <=8-bit codes")
    vals = np.asarray(vals, dtype=np.int64)[:256] & ((1 << lengths) - 1)
    return (vals | (lengths << 8)).astype(np.int16)


def pack_pc_table(vals: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per-chunk cells' 256 entries ``val | nb << 12`` ([256] or [m, 256]
    of each): uint16 values held in int16 (the kernel reads them as
    uint16; ``val`` masked to its ``nb`` bits).  Raises ValueError for a
    code longer than 12 bits."""
    lengths = np.asarray(lengths, dtype=np.int64)[..., :256]
    if lengths.size and int(lengths.max()) > PC_TMAX:
        raise ValueError("per-chunk encode table must have <=12-bit codes")
    vals = np.asarray(vals, dtype=np.int64)[..., :256] & ((1 << lengths) - 1)
    return (vals | (lengths << 12)).astype(np.uint16).view(np.int16)


def row_words(seg: int, code_bits: int = TMAX) -> int:
    """Words of one output row: ``code_bits`` per symbol plus the
    sentinel."""
    return (code_bits * seg + 1 + 31) // 32


def _check(name, planes, tables, seg, streams):
    dev = planes.device
    for what, t, dt in (("planes", planes, torch.int32), ("table", tables, torch.int16),
                        ("streams", streams, torch.int64)):
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, planes on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {what} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if streams.dim() != 1:
        raise ValueError(f"{name}: streams must be 1-D")
    if seg % 4 or not 0 <= seg < 1 << 27:
        raise ValueError(f"{name}: seg {seg} must be a multiple of 4 below 2^27")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def _launch(name, planes, tables, seg, streams, code_bits, *split):
    """``split``: ``huf_pc_encode``'s warps a stream (none for K7)."""
    dev = planes.device
    S = int(streams.numel())
    rw = row_words(seg, code_bits)
    rows = torch.empty((S, rw), dtype=torch.int32, device=dev)
    total_bits = torch.empty(S, dtype=torch.int32, device=dev)
    if S:
        kernels.launch(
            name, dev, planes.data_ptr(), streams.data_ptr(), tables.data_ptr(), S,
            seg // 4, rw, streams_per_warp(seg), *split, rows.data_ptr(),
            total_bits.data_ptr(),
        )
    return rows, total_bits


def huf_shared_encode(
    planes: torch.Tensor, table: torch.Tensor, seg: int, streams: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode S streams of ``seg`` symbols with one shared table.

    ``planes`` holds the symbols as int32 words (little-endian bytes);
    stream ``s`` is the ``seg`` bytes from word ``streams[s]`` of the
    flattened ``planes``.  ``table`` is :func:`pack_etable`'s 256 entries.
    Returns (rows int32 [S, seg / 4 + 1], total_bits int32 [S]): stream
    ``s``'s bytes are the first ``ceil(bits / 8)`` bytes of row ``s``, with
    ``bits = total_bits[s] & 0x3FFFFFFF`` (code bits + 1 sentinel); bit 30
    of ``total_bits`` is set when a symbol had no code.  Row bytes past a
    stream's length are undefined.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check("huf_shared_encode", planes, table, seg, streams)
    if table.shape != (256,):
        raise ValueError(f"huf_shared_encode: table shape {tuple(table.shape)} != (256,)")
    if planes.device.type == "cpu":
        return huf_shared_encode_plain(planes, table, seg, streams)
    return _launch("huf_shared_encode", planes, table, seg, streams, TMAX)


def huf_pc_encode(
    planes: torch.Tensor, tables: torch.Tensor, seg: int, streams: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode S streams of ``seg`` symbols, stream ``s`` with table ``s //
    4`` of ``tables`` ([ceil(S / 4), 256] int16, :func:`pack_pc_table`'s
    entries: the 4 streams of each cell in turn).

    ``planes`` and ``streams`` as in :func:`huf_shared_encode`.  Returns
    (rows int32 [S, ceil((12 seg + 1) / 32)], total_bits int32 [S]), read
    as :func:`huf_shared_encode`'s.  Streams of ``WARP_SYMBOLS`` symbols
    or more are each split over :func:`parts_per_stream` warps.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check("huf_pc_encode", planes, tables, seg, streams)
    S = int(streams.numel())
    if tables.dim() != 2 or tables.shape[1] != 256 or tables.shape[0] != -(-S // 4):
        raise ValueError(f"huf_pc_encode: tables {tuple(tables.shape)} for {S} streams, "
                         f"want [ceil(S / 4), 256]")
    parts = parts_per_stream(S, seg)
    if parts < 1 or parts > MAX_PARTS or parts & (parts - 1):
        raise ValueError(f"huf_pc_encode: {parts} parts a stream, want a power of 2 "
                         f"<= {MAX_PARTS}")
    if planes.device.type == "cpu":
        return huf_pc_encode_plain(planes, tables, seg, streams)
    return _launch("huf_pc_encode", planes, tables, seg, streams, PC_TMAX, parts)


def huf_shared_encode_plain(planes, table, seg: int, streams):
    """Plain PyTorch version of :func:`huf_shared_encode`."""
    tab = table.to(torch.int64)
    return _encode_plain(planes, lambda syms: tab[syms], seg, streams, TMAX)


def huf_pc_encode_plain(planes, tables, seg: int, streams):
    """Plain PyTorch version of :func:`huf_pc_encode`: the shared plain
    version with each stream's symbols looked up in its cell's table."""
    tab = tables.to(torch.int64) & 0xFFFF
    cell = torch.arange(int(streams.numel()), device=planes.device)[:, None] // 4
    return _encode_plain(planes, lambda syms: tab[cell, syms], seg, streams, PC_TMAX)


def _encode_plain(planes, lookup, seg: int, streams, code_bits: int):
    """Vectorised over streams: ``lookup`` maps the [S, seg] symbols to
    their entries; every code's bit offset is an exclusive prefix sum of
    the code lengths, and its value lands in the one or two words it spans
    (codes never overlap, so adding the parts is or-ing them)."""
    dev = planes.device
    S = int(streams.numel())
    rw = row_words(seg, code_bits)
    idx = streams[:, None] + torch.arange(seg // 4, device=dev)
    words = planes.reshape(-1)[idx]  # [S, seg / 4]
    syms = words.contiguous().view(torch.uint8).reshape(S, seg).flip(1)
    ent = lookup(syms.to(torch.int64))
    nb = ent >> code_bits
    val = ent & ((1 << code_bits) - 1)
    end = nb.cumsum(1)
    pos = end - nb
    code_bits_s = end[:, -1] if seg else torch.zeros(S, dtype=torch.int64, device=dev)
    bad = (nb == 0).any(1).to(torch.int64)
    acc = torch.zeros((S, rw + 1), dtype=torch.int64, device=dev)
    shifted = val << (pos & 31)
    acc.scatter_add_(1, pos >> 5, shifted & _M32)
    acc.scatter_add_(1, (pos >> 5) + 1, shifted >> 32)
    acc.scatter_add_(1, (code_bits_s >> 5)[:, None], (1 << (code_bits_s & 31))[:, None])
    rows = acc[:, :rw].to(torch.int32).contiguous()
    return rows, ((code_bits_s + 1) | (bad << 30)).to(torch.int32)
