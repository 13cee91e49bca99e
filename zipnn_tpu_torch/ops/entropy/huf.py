"""HUF (Huffman) codec — stream-format-compatible from-scratch implementation.

Implements the HUF block format used by the reference's entropy layer (the
``HUF_compress``/``HUF_decompress`` entry points the C core calls at
csrc/zipnn_core.c:366 and :807): a weight-table header (FSE-compressed or
raw 4-bit), canonical prefix codes limited to 12 bits, and four independent
backward bitstreams joined by a 6-byte jump table.  Format re-derived from
the published zstd/FSE specification (RFC 8878 §4.2) — no code taken from
the reference.

Departure by design: code lengths are assigned with package-merge, which is
*optimal* under a length limit, so our compressed size is <= a stock HUF
encoder's for the same table-log; both sides decode each other because the
canonical-code convention is shared.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import fse
from .bitstream import BitReader

HUF_TABLELOG_MAX = 12
HUF_TABLELOG_DEFAULT = 11
HUF_BLOCKSIZE_MAX = 128 * 1024
HUF_SYMBOLVALUE_MAX = 255


# ---------------------------------------------------------------------------
# Code-length assignment
# ---------------------------------------------------------------------------

def _huffman_lengths(counts: Sequence[Tuple[int, int]]) -> dict:
    """Plain Huffman code lengths via a heap; counts = [(freq, symbol)]."""
    heap = [(freq, sym, None, None) for freq, sym in counts]
    heapq.heapify(heap)
    tick = 256  # internal-node ids above any symbol value: unique tie-break
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        tick += 1
        heapq.heappush(heap, (a[0] + b[0], tick, a, b))
    lengths: dict = {}

    def walk(node, depth):
        stack = [(node, depth)]
        while stack:
            nd, d = stack.pop()
            if nd[2] is None:
                lengths[nd[1]] = max(d, 1)
            else:
                stack.append((nd[2], d + 1))
                stack.append((nd[3], d + 1))

    walk(heap[0], 0)
    return lengths


def _package_merge_lengths(counts: Sequence[Tuple[int, int]], max_len: int) -> dict:
    """Optimal length-limited code lengths (package-merge, boundary form)."""
    n = len(counts)
    leaves = sorted((freq, (sym,)) for freq, sym in counts)
    prev: List[Tuple[int, tuple]] = []
    for _ in range(max_len):
        packages = [
            (prev[i][0] + prev[i + 1][0], prev[i][1] + prev[i + 1][1])
            for i in range(0, len(prev) - 1, 2)
        ]
        prev = sorted(leaves + packages)
    lengths = {sym: 0 for _, (sym,) in leaves}
    for _, syms in prev[: 2 * (n - 1)]:
        for s in syms:
            lengths[s] += 1
    return lengths


def build_code_lengths(count: np.ndarray, max_nb_bits: int) -> Optional[np.ndarray]:
    """Length array (0 = absent) with Kraft equality and max <= max_nb_bits."""
    present = [(int(count[s]), s) for s in np.nonzero(count)[0]]
    n = len(present)
    if n < 2:
        return None  # RLE handled earlier
    if (1 << max_nb_bits) < n:
        return None
    lengths = _huffman_lengths(present)
    if max(lengths.values()) > max_nb_bits:
        lengths = _package_merge_lengths(present, max_nb_bits)
    out = np.zeros(256, dtype=np.uint8)
    for s, l in lengths.items():
        out[s] = l
    # Kraft equality is required by the weight format (the implied last
    # weight must make the total a clean power of two)
    kraft = sum(1 << (max_nb_bits - l) for l in lengths.values())
    if kraft != (1 << max_nb_bits):
        raise AssertionError(f"Kraft inequality: {kraft} != {1 << max_nb_bits}")
    return out


def canonical_values(lengths: np.ndarray, max_nb_bits: int) -> np.ndarray:
    """Canonical code values: within a length, ascending by symbol; shorter
    codes numerically on top (matches the shared DTable-fill convention)."""
    nb_per_rank = np.zeros(max_nb_bits + 2, dtype=np.int64)
    for l in lengths:
        nb_per_rank[l] += 1
    val_per_rank = np.zeros(max_nb_bits + 2, dtype=np.int64)
    mn = 0
    for n in range(max_nb_bits, 0, -1):
        val_per_rank[n] = mn
        mn += nb_per_rank[n]
        mn >>= 1
    vals = np.zeros(256, dtype=np.uint16)
    nxt = val_per_rank.copy()
    for s in range(256):
        l = lengths[s]
        if l:
            vals[s] = nxt[l]
            nxt[l] += 1
    return vals


# ---------------------------------------------------------------------------
# Weight-table header
# ---------------------------------------------------------------------------

def write_ctable(lengths: np.ndarray, max_symbol_value: int, table_log: int) -> Optional[bytes]:
    """Serialize code lengths as HUF weights (FSE-compressed or raw 4-bit).

    Weights cover symbols ``0 .. max_symbol_value-1``; the last present
    symbol's weight is implied by Kraft equality.  Returns None when neither
    representation fits (the chunk is then stored raw).
    """
    weights = [
        (table_log + 1 - int(lengths[s])) if lengths[s] else 0
        for s in range(max_symbol_value)
    ]
    if len(weights) > 1:
        comp = fse.compress(weights, max_symbol_value=HUF_TABLELOG_MAX, max_table_log=6)
        if isinstance(comp, bytes) and 1 < len(comp) < max_symbol_value / 2 and len(comp) < 128:
            return bytes([len(comp)]) + comp
    if max_symbol_value > 128:
        return None
    header = bytearray([127 + max_symbol_value])
    padded = weights + [0]
    for i in range(0, max_symbol_value, 2):
        header.append((padded[i] << 4) | padded[i + 1])
    return bytes(header)


def read_stats(data: bytes) -> Tuple[List[int], List[int], int, int, int]:
    """Parse a weight header.

    Returns (weights incl. the implied last, rank_stats, table_log,
    n_symbols, bytes_consumed).
    """
    data = bytes(data)
    if not data:
        raise ValueError("empty HUF header")
    i_size = data[0]
    if i_size >= 128:
        o_size = i_size - 127
        packed_len = (o_size + 1) // 2
        if 1 + packed_len > len(data):
            raise ValueError("truncated HUF weight header")
        weights = []
        for i in range(o_size):
            b = data[1 + (i >> 1)]
            weights.append((b >> 4) if (i & 1) == 0 else (b & 15))
        consumed = 1 + packed_len
    else:
        if 1 + i_size > len(data):
            raise ValueError("truncated HUF weight header")
        weights = fse.decompress(data[1 : 1 + i_size], max_out=HUF_SYMBOLVALUE_MAX)
        o_size = len(weights)
        if o_size > HUF_SYMBOLVALUE_MAX:
            raise ValueError("too many HUF weights")
        consumed = 1 + i_size

    rank_stats = [0] * (HUF_TABLELOG_MAX + 1)
    weight_total = 0
    for w in weights:
        if w > HUF_TABLELOG_MAX:
            raise ValueError("corrupt HUF weights")
        rank_stats[w] += 1
        weight_total += (1 << w) >> 1
    if weight_total == 0:
        raise ValueError("corrupt HUF weights (no weight)")

    table_log = weight_total.bit_length()  # highbit + 1
    if table_log > HUF_TABLELOG_MAX:
        raise ValueError("HUF tableLog too large")
    total = 1 << table_log
    rest = total - weight_total
    last_weight = rest.bit_length()  # highbit + 1
    if rest != (1 << (last_weight - 1)):
        raise ValueError("corrupt HUF weights (non-power-of-2 rest)")
    weights.append(last_weight)
    rank_stats[last_weight] += 1
    if rank_stats[1] < 2 or (rank_stats[1] & 1):
        raise ValueError("corrupt HUF weights (invalid tree)")
    return weights, rank_stats, table_log, o_size + 1, consumed


def build_dtable(
    weights: Sequence[int], rank_stats: Sequence[int], table_log: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-symbol decode table: index by a table_log-bit window ->
    (symbol, nb_bits)."""
    table_size = 1 << table_log
    rank_val = [0] * (HUF_TABLELOG_MAX + 2)
    next_start = 0
    for n in range(1, table_log + 1):
        cur = next_start
        next_start += rank_stats[n] << (n - 1)
        rank_val[n] = cur
    sym_t = np.zeros(table_size, dtype=np.uint8)
    nb_t = np.zeros(table_size, dtype=np.uint8)
    for s, w in enumerate(weights):
        if w == 0:
            continue
        length = (1 << w) >> 1
        start = rank_val[w]
        sym_t[start : start + length] = s
        nb_t[start : start + length] = table_log + 1 - w
        rank_val[w] += length
    return sym_t, nb_t


# ---------------------------------------------------------------------------
# Bitstream encode / decode (one stream)
# ---------------------------------------------------------------------------

def encode_stream(
    part: np.ndarray, vals: np.ndarray, lengths: np.ndarray
) -> bytes:
    """Encode one segment: symbols written in descending index order, then
    the closing sentinel bit (vectorized bit-matrix construction)."""
    syms = np.ascontiguousarray(part, dtype=np.uint8)
    nb_rev = lengths[syms[::-1]].astype(np.int64)
    v_rev = vals[syms[::-1]].astype(np.uint32)
    pos = np.zeros(len(nb_rev), dtype=np.int64)
    if len(nb_rev) > 1:
        np.cumsum(nb_rev[:-1], out=pos[1:])
    total_bits = int(nb_rev.sum()) + 1  # + sentinel
    bits = np.zeros(((total_bits + 7) // 8) * 8, dtype=np.uint8)
    max_b = int(nb_rev.max()) if len(nb_rev) else 0
    for j in range(max_b):
        mask = nb_rev > j
        bits[pos[mask] + j] = (v_rev[mask] >> j) & 1
    bits[total_bits - 1] = 1  # sentinel
    return np.packbits(bits, bitorder="little").tobytes()


def decode_stream(
    stream: bytes, sym_t: np.ndarray, nb_t: np.ndarray, table_log: int, out_len: int
) -> np.ndarray:
    """Reference (scalar) decoder for one stream; the batched/lockstep and
    native decoders are validated against this."""
    rd = BitReader(stream)
    out = np.empty(out_len, dtype=np.uint8)
    for i in range(out_len):
        idx = rd.peek(table_log)
        out[i] = sym_t[idx]
        rd.bits_left -= int(nb_t[idx])
    if rd.bits_left != 0:
        raise ValueError("corrupt HUF stream (not fully consumed)")
    return out


# ---------------------------------------------------------------------------
# Block-level API (4-stream layout)
# ---------------------------------------------------------------------------

def segment_sizes(n: int) -> List[int]:
    seg = (n + 3) // 4
    return [seg, seg, seg, n - 3 * seg]


def compress(data: np.ndarray) -> Optional[bytes]:
    """HUF-compress one block.

    Returns None when the block should be stored raw (incompressible, too
    large, or too small) — mirroring every ``return 0`` path of the
    reference entry point, including the ``(srcSize >> 7) + 4`` histogram
    heuristic, so the chunk-type decisions in the container match.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    if n == 0 or n > HUF_BLOCKSIZE_MAX:
        return None
    count = np.bincount(data, minlength=256).astype(np.int64)
    max_sv = int(np.nonzero(count)[0][-1])
    largest = int(count.max())
    if largest == n:
        return bytes(data[:1])  # single repeated symbol -> 1-byte RLE block
    if largest <= (n >> 7) + 4:
        return None  # heuristic: probably not compressible enough
    if n < 12:
        return None  # too small for the 4-stream layout to ever win

    table_log = fse.optimal_table_log(HUF_TABLELOG_DEFAULT, n, max_sv, minus=1)
    lengths = build_code_lengths(count, table_log)
    if lengths is None:
        return None
    table_log = int(lengths.max())
    header = write_ctable(lengths, max_sv, table_log)
    if header is None or len(header) + 12 >= n:
        return None
    vals = canonical_values(lengths, table_log)

    segs = segment_sizes(n)
    streams = []
    off = 0
    for s in segs:
        enc = encode_stream(data[off : off + s], vals, lengths)
        if len(enc) == 0 or len(enc) > 65535:
            return None
        streams.append(enc)
        off += s
    jump = b"".join(len(streams[i]).to_bytes(2, "little") for i in range(3))
    out = header + jump + b"".join(streams)
    if len(out) >= n - 1:
        return None
    return out


def decompress(data: bytes, dst_size: int) -> np.ndarray:
    """Inverse of :func:`compress` including the raw/RLE special blocks."""
    data = bytes(data)
    c_size = len(data)
    if dst_size == 0:
        raise ValueError("dst_size == 0")
    if c_size > dst_size:
        raise ValueError("corrupt HUF block (larger than destination)")
    if c_size == dst_size:
        return np.frombuffer(data, dtype=np.uint8).copy()
    if c_size == 1:
        return np.full(dst_size, data[0], dtype=np.uint8)

    weights, rank_stats, table_log, _, consumed = read_stats(data)
    sym_t, nb_t = build_dtable(weights, rank_stats, table_log)
    rest = data[consumed:]
    if len(rest) < 6:
        raise ValueError("corrupt HUF block (missing jump table)")
    l1 = int.from_bytes(rest[0:2], "little")
    l2 = int.from_bytes(rest[2:4], "little")
    l3 = int.from_bytes(rest[4:6], "little")
    l4 = len(rest) - 6 - l1 - l2 - l3
    if l4 < 0:
        raise ValueError("corrupt HUF block (jump table overruns input)")
    segs = segment_sizes(dst_size)
    out = np.empty(dst_size, dtype=np.uint8)
    off_in = 6
    off_out = 0
    for stream_len, seg in zip((l1, l2, l3, l4), segs):
        out[off_out : off_out + seg] = decode_stream(
            rest[off_in : off_in + stream_len], sym_t, nb_t, table_log, seg
        )
        off_in += stream_len
        off_out += seg
    return out


def compress_with_table(
    data: np.ndarray, lengths: np.ndarray, vals: np.ndarray, header: bytes
) -> Optional[bytes]:
    """HUF-compress one block with a caller-supplied (shared) code table.

    Used by the shared-table encode mode: ``header`` is the serialized
    weight table (identical bytes for every block sharing the table).  The
    caller decides RLE/raw per block; this returns None on the same
    size-guard paths as :func:`compress` so chunk-type decisions stay
    engine-independent.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    if n == 0 or n > HUF_BLOCKSIZE_MAX or n < 12:
        return None
    if np.any(lengths[data] == 0):
        raise ValueError("shared table lacks a code for a present symbol")
    segs = segment_sizes(n)
    streams = []
    off = 0
    for s in segs:
        enc = encode_stream(data[off : off + s], vals, lengths)
        if len(enc) == 0 or len(enc) > 65535:
            return None
        streams.append(enc)
        off += s
    jump = b"".join(len(streams[i]).to_bytes(2, "little") for i in range(3))
    out = header + jump + b"".join(streams)
    if len(out) >= n - 1:
        return None
    return out


def build_shared_table(count: np.ndarray, max_bits: int = 8):
    """Shared-table plan from a (plane-)global histogram.

    Returns (lengths, vals, header, table_log) or None when no usable table
    exists (fewer than 2 distinct symbols, or the header does not serialize).
    """
    lengths = build_code_lengths(count.astype(np.int64), max_bits)
    if lengths is None:
        return None
    table_log = int(lengths.max())
    max_sv = int(np.nonzero(count)[0][-1])
    header = write_ctable(lengths, max_sv, table_log)
    if header is None:
        return None
    vals = canonical_values(lengths, table_log)
    return lengths, vals, header, table_log
