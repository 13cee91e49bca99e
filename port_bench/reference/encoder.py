"""Plain reference encoder of the ``.znn`` per-chunk-table container.

It writes, for a tensor's bytes, the container that the golden encoder
writes (``ZipNN(input_format="torch")`` with its defaults: the AUTO
method, 256 KB chunks, threshold 0.95, the bounded check after 10 %),
byte for byte: the 32-byte header and the packed shape, the chunk-type
table, the cumulative sizes, and every plane's cells, Huffman (weight
header, jump table, four backward streams), RLE or raw.

The same decisions as the golden model, in the same order, made from the
same numbers: each cell's histogram and Huffman table (``entropy.py``, a
frozen copy of the golden model's table code) and its exact coded length
decide Huffman, RLE or raw before any stream is written.  Only the bit
packing is batched: the symbols of many cells are turned into bit
positions with a cumulative sum and summed into 32-bit words with one
``index_add_``, on whatever device holds the input (the card in the
benchmark, the CPU in its tests).  Plain PyTorch and numpy; nothing of
the program under test.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import entropy

# name -> (header dtype code, planes, byte_reorder, bit_reorder)
DTYPES = {
    "bfloat16": (6, 2, 10, 1),
    "float16": (4, 2, 10, 0),
    "float32": (1, 4, 220, 1),
}
VERSION = (0, 5, 3)
FORMAT_TORCH = 2
CHUNK = 256 * 1024
THRESHOLD = 0.95
CHECK_PERCENT = 10
ROWS_PER_BATCH = 128  # cells packed per batch: bounds the int64 temporaries


def pack_shape(shape: Sequence[int]) -> bytes:
    """Tensor dims, each with a 1/2/4/8-byte width indicator."""
    out = bytearray([len(shape)])
    for d in shape:
        d = int(d)
        for ind, fmt, lim in ((1, "<B", 1 << 8), (2, "<H", 1 << 16), (4, "<I", 1 << 32)):
            if d < lim:
                out += bytes([ind]) + struct.pack(fmt, d)
                break
        else:
            out += bytes([8]) + struct.pack("<Q", d)
    return bytes(out)


def header(dtype: str, shape: Sequence[int], original_len: int, payload_len: int,
           chunk: int = CHUNK) -> bytes:
    """The frame header of a tensor container, then its packed shape."""
    code, _, byte_reorder, bit_reorder = DTYPES[dtype]
    ext = pack_shape(shape)
    h = bytearray(32)
    h[0:2] = b"ZN"
    h[2:5] = bytes(VERSION)
    h[5], h[6], h[7], h[8] = byte_reorder, bit_reorder, 0, FORMAT_TORCH
    h[14] = chunk.bit_length() - 1
    h[15] = code
    h[16:24] = int(original_len).to_bytes(8, "little")
    h[24:32] = int(32 + len(ext) + payload_len).to_bytes(8, "little")
    return bytes(h) + ext


def rotate_sign(flat: torch.Tensor, planes: int) -> torch.Tensor:
    """The sign bit moved below the exponent in every whole 32-bit word
    (bf16: two lanes a word; fp32: one); trailing bytes unchanged."""
    out = flat.clone()
    nw = flat.numel() // 4
    if nw:
        u = out[: nw * 4].view(torch.int32)
        if planes == 2:
            u.copy_(((u << 1) & -16711936) | ((u >> 8) & 0x800080) | (u & 0x7F007F))
        else:
            u.copy_(((u << 1) & -16777216) | ((u >> 8) & 0x800000) | (u & 0x7FFFFF))
    return out


def plane_lengths(total: int, planes: int) -> List[int]:
    q, r = divmod(total, planes)
    return [q + (1 if b < r else 0) for b in range(planes)]


def cell_table(count: np.ndarray, n: int):
    """What ``huf.compress`` does with a cell before writing a stream:
    ``("raw",)``, ``("rle", byte)`` or ``("huf", weight header, lengths,
    values)``."""
    if n == 0 or n > entropy.HUF_BLOCKSIZE_MAX:
        return ("raw",)
    largest = int(count.max())
    if largest == n:
        return ("rle", int(np.argmax(count)))
    if largest <= (n >> 7) + 4 or n < 12:
        return ("raw",)
    max_sv = int(np.nonzero(count)[0][-1])
    table_log = entropy.optimal_table_log(entropy.HUF_TABLELOG_DEFAULT, n, max_sv, minus=1)
    lengths = entropy.build_code_lengths(count.astype(np.int64), table_log)
    if lengths is None:
        return ("raw",)
    table_log = int(lengths.max())
    head = entropy.write_ctable(lengths, max_sv, table_log)
    if head is None or len(head) + 12 >= n:
        return ("raw",)
    return ("huf", head, lengths, entropy.canonical_values(lengths, table_log))


def _stream_bounds(m: int) -> List[Tuple[int, int]]:
    seg = (m + 3) // 4
    return [(0, seg), (seg, 2 * seg), (2 * seg, 3 * seg), (3 * seg, m)]


def _symbol_bits(rows: torch.Tensor, lengths: torch.Tensor, values: torch.Tensor):
    """Per symbol of ``rows`` ([k, m] uint8, one cell a row): its code
    length and value, the bit offset of its code inside its stream (the
    codes of a stream go last symbol first), and each stream's bit count
    ([k, 4])."""
    k, m = rows.shape
    idx = rows.long() + 256 * torch.arange(k, device=rows.device)[:, None]
    nb = lengths.reshape(-1)[idx]
    val = values.reshape(-1)[idx]
    cs = torch.cumsum(nb, dim=1)
    zero = torch.zeros(k, 1, dtype=cs.dtype, device=cs.device)
    ends = [e for _, e in _stream_bounds(m)]
    starts = [s for s, _ in _stream_bounds(m)]
    csz = torch.cat([zero, cs], dim=1)
    end_cs = torch.stack([csz[:, e] for e in ends], dim=1)  # [k, 4]
    totals = end_cs - torch.stack([csz[:, s] for s in starts], dim=1)
    stream_of = torch.zeros(m, dtype=torch.long, device=rows.device)
    for s, (a, _) in enumerate(_stream_bounds(m)):
        stream_of[a:] = s
    pos = end_cs[:, stream_of] - cs
    return nb, val, pos, stream_of, totals


def _pack(rows, lengths, values) -> Tuple[np.ndarray, np.ndarray]:
    """The four streams of each cell of ``rows``, packed: returns (the
    streams' bytes back to back, cell by cell, on the host; [k, 4] stream
    byte lengths)."""
    nb, val, pos, stream_of, totals = _symbol_bits(rows, lengths, values)
    k = rows.shape[0]
    nbytes = (totals + 8) // 8  # the codes and the closing 1 bit
    base = torch.cumsum(nbytes.reshape(-1), 0) - nbytes.reshape(-1)
    total = int(nbytes.sum())
    base = base.reshape(k, 4)
    gbit = base[:, stream_of] * 8 + pos
    acc = torch.zeros(total // 4 + 3, dtype=torch.int64, device=rows.device)
    acc.index_add_(0, (gbit >> 5).reshape(-1), (val << (gbit & 31)).reshape(-1))
    sent = (base * 8 + totals).reshape(-1)
    acc.index_add_(0, sent >> 5, torch.ones_like(sent) << (sent & 31))
    words = (acc[1:] & 0xFFFFFFFF) | (acc[:-1] >> 32)
    words = torch.cat([acc[:1] & 0xFFFFFFFF, words])
    by = torch.stack([(words >> (8 * i)) & 0xFF for i in range(4)], dim=1)
    out = by.to(torch.uint8).reshape(-1)[:total].cpu().numpy()
    return out, nbytes.cpu().numpy()


def _stream_totals(rows, lengths, values) -> np.ndarray:
    return _symbol_bits(rows, lengths, values)[4].cpu().numpy()


def _tables(cells, device):
    lengths = torch.tensor(np.stack([c[2] for c in cells]), dtype=torch.int64, device=device)
    values = torch.tensor(np.stack([c[3] for c in cells]).astype(np.int64), device=device)
    return lengths, values


def encode(flat: torch.Tensor, shape: Sequence[int], dtype: str = "bfloat16",
           chunk: int = CHUNK, threshold: float = THRESHOLD,
           check_percent: int = CHECK_PERCENT) -> bytes:
    """The container of the tensor whose bytes are ``flat`` (uint8, any
    device)."""
    _, nbuf, _, bit_reorder = DTYPES[dtype]
    flat = flat.reshape(-1)
    n = flat.numel()
    rot = rotate_sign(flat, nbuf) if bit_reorder else flat
    n_chunks = -(-n // chunk)
    n_full = n // chunk
    # cell (b, c): rows of the full chunks, then the tail chunk's planes
    cells: Dict[Tuple[int, int], torch.Tensor] = {}
    full = rot[: n_full * chunk].view(n_full, chunk // nbuf, nbuf) if n_full else None
    tail_len = n - n_full * chunk
    sizes = {}
    for b in range(nbuf):
        for c in range(n_full):
            sizes[(b, c)] = chunk // nbuf
    if tail_len:
        tail = rot[n_full * chunk:]
        for b, ln in enumerate(plane_lengths(tail_len, nbuf)):
            cells[(b, n_full)] = tail[b::nbuf][:ln]
            sizes[(b, n_full)] = ln

    def row(b, c):
        return full[c, :, b] if c < n_full else cells[(b, c)]

    # histograms, one bincount a plane over its full chunks
    counts = {}
    for b in range(nbuf):
        if n_full:
            idx = full[:, :, b].long() + 256 * torch.arange(n_full, device=flat.device)[:, None]
            h = torch.bincount(idx.reshape(-1), minlength=256 * n_full).reshape(n_full, 256)
            h = h.cpu().numpy()
            for c in range(n_full):
                counts[(b, c)] = h[c]
        if tail_len:
            counts[(b, n_full)] = torch.bincount(cells[(b, n_full)].long(),
                                                 minlength=256).cpu().numpy()

    k_check = -(-n_chunks // check_percent) if check_percent > 0 else None
    if k_check is not None and k_check >= n_chunks - 1:
        k_check = None
    kinds: Dict[Tuple[int, int], tuple] = {}
    stored_len: Dict[Tuple[int, int], int] = {}

    def decide(keys):
        """Each cell's kind and stored length, as the golden model decides
        them: the table first, then the coded length against the limits."""
        plan = {key: cell_table(counts[key], sizes[key]) for key in keys}
        stored = {key: 1 for key in keys if plan[key][0] == "rle"}
        cand = [key for key in keys if plan[key][0] == "huf"]
        for group in _groups(cand, n_full):
            rows = torch.stack([row(*key) for key in group])
            totals = _stream_totals(rows, *_tables([plan[key] for key in group], flat.device))
            for key, t in zip(group, totals):
                nbytes = (t + 8) // 8
                ln = len(plan[key][1]) + 6 + int(nbytes.sum())
                if nbytes.max() > 65535 or ln >= sizes[key] - 1:
                    plan[key] = ("raw",)
                else:
                    stored[key] = ln
        for key in keys:
            if plan[key][0] != "raw" and not stored[key] < sizes[key] * threshold:
                plan[key] = ("raw",)
            kinds[key] = plan[key]
            stored_len[key] = sizes[key] if plan[key][0] == "raw" else stored[key]

    order = [(b, c) for c in range(n_chunks) for b in range(nbuf)]
    if k_check is None:
        decide(order)
    else:
        decide([(b, c) for b, c in order if c <= k_check])
        stored = [0] * nbuf
        uncomp = [0] * nbuf
        for (b, c) in order:
            if c <= k_check:
                stored[b] += stored_len[(b, c)]
                uncomp[b] += sizes[(b, c)]
        dropped = [float(int(stored[b])) > float(int(uncomp[b])) * threshold
                   for b in range(nbuf)]
        decide([(b, c) for b, c in order if c > k_check and not dropped[b]])
        for (b, c) in order:
            if c > k_check and dropped[b]:
                kinds[(b, c)] = ("raw",)

    # the Huffman cells' streams
    coded: Dict[Tuple[int, int], bytes] = {}
    huf_keys = [key for key in order if kinds[key][0] == "huf"]
    for group in _groups(huf_keys, n_full):
        rows = torch.stack([row(*key) for key in group])
        lengths, values = _tables([kinds[key] for key in group], flat.device)
        packed, nbytes = _pack(rows, lengths, values)
        off = 0
        for key, nb in zip(group, nbytes):
            streams = packed[off : off + int(nb.sum())].tobytes()
            off += int(nb.sum())
            jump = b"".join(int(x).to_bytes(2, "little") for x in nb[:3])
            coded[key] = kinds[key][1] + jump + streams

    host = rot.cpu().numpy()
    types = np.zeros((nbuf, n_chunks), dtype=np.uint8)
    lens = np.zeros((nbuf, n_chunks), dtype=np.uint64)
    blobs: List[List[bytes]] = [[] for _ in range(nbuf)]
    for (b, c) in order:
        kind = kinds[(b, c)]
        if kind[0] == "huf":
            blob = coded[(b, c)]
        elif kind[0] == "rle":
            blob = bytes([kind[1]])
        else:
            lo = c * chunk
            hi = min(lo + chunk, n)
            blob = host[lo + b : hi : nbuf][: sizes[(b, c)]].tobytes()
        types[b, c] = 0 if kind[0] == "raw" else 1
        lens[b, c] = len(blob)
        blobs[b].append(blob)
    cumulative = np.cumsum(lens, axis=1, dtype=np.uint64).astype("<u8")
    payload = b"".join([types.tobytes(), cumulative.tobytes()] + [x for p in blobs for x in p])
    return header(dtype, shape, n, len(payload), chunk) + payload


def _groups(keys, n_full: int):
    """Batches of cells of one row length: full chunks of a plane together
    (at most ``ROWS_PER_BATCH``), each tail cell alone."""
    full = [k for k in keys if k[1] < n_full]
    for i in range(0, len(full), ROWS_PER_BATCH):
        yield full[i : i + ROWS_PER_BATCH]
    for k in keys:
        if k[1] >= n_full:
            yield [k]
