"""Per-cell-table Huffman decode: host table prep, the CUDA kernel's wrapper
and its plain PyTorch version.

The counterpart of the JAX package's ``ops/pallas_huf_pc.py``.  Every
(plane, chunk) cell of a reference-profile container carries its own
Huffman table (tableLog <= 12) and four backward bitstreams.  The kernel
(``csrc/huf_pc.cu``) decodes one stream per thread straight from the
uploaded payload and writes symbol bytes, so the TPU's row gather (K3) and
d-index -> symbol post pass (K4) have no counterpart here.

Table layout: one row of ``2^tlog_k`` uint16 entries per cell, entry =
``symbol | nb_bits << 8`` (``huf.build_dtable``), only the first
``2^tlog`` entries of a cell with tableLog ``tlog`` in use; torch has no
uint16 arithmetic on the CPU, so rows are int16 tensors (entries < 2^13).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .entropy import huf


# ---------------------------------------------------------------------------
# host: per-cell table preparation
# ---------------------------------------------------------------------------

def cell_tables(headers: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Parse per-cell weight headers into decode tables.

    Returns (tables int16 [n, 2^tlog_k], tlogs int32 [n], tlog_k).  Equal
    headers share one parse.  Raises ValueError (with ``.index``, the first
    bad cell) on a corrupt header.
    """
    parsed = {}
    rows = []
    for i, hdr in enumerate(headers):
        got = parsed.get(hdr)
        if got is None:
            try:
                weights, rank_stats, tlog, _, _ = huf.read_stats(hdr)
            except ValueError as exc:
                exc.index = i
                raise
            sym_t, nb_t = huf.build_dtable(weights, rank_stats, tlog)
            got = (sym_t.astype(np.int16) | (nb_t.astype(np.int16) << 8), tlog)
            parsed[hdr] = got
        rows.append(got)
    tlog_k = max([1] + [t for _, t in rows])
    tables = np.zeros((len(rows), 1 << tlog_k), dtype=np.int16)
    tlogs = np.empty(len(rows), dtype=np.int32)
    for i, (ent, tlog) in enumerate(rows):
        tables[i, : ent.size] = ent
        tlogs[i] = tlog
    return tables, tlogs, tlog_k


def sentinel_bits(last_bytes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Start bit of each backward stream: ``8*(len-1) + msb(last byte)``.
    The caller has checked that no last byte is 0 (missing sentinel)."""
    msb = np.floor(np.log2(last_bytes.astype(np.float64))).astype(np.int64)
    return (8 * (lens.astype(np.int64) - 1) + msb).astype(np.int32)


# ---------------------------------------------------------------------------
# the kernel's wrapper and its plain version
# ---------------------------------------------------------------------------

def huf_pc_decode(
    payload: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    bits0: torch.Tensor,
    out_offs: torch.Tensor,
    out_lens: torch.Tensor,
    cells: torch.Tensor,
    tlogs: torch.Tensor,
    tables: torch.Tensor,
    n_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode S streams into one uint8 buffer of ``n_out`` bytes.

    Stream ``s`` covers payload bytes ``[starts[s], starts[s] + lens[s])``,
    starts at bit ``bits0[s]``, uses table row ``cells[s]`` (tableLog
    ``tlogs[cells[s]]``) and writes ``out_lens[s]`` symbols at
    ``out_offs[s]``.  Returns (out uint8 [n_out], bits_left int32 [S]); a
    stream decoded exactly ends with ``bits_left == 0``.  Bytes of ``out``
    that no stream covers are undefined.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    dev = payload.device
    S = int(starts.numel())
    for name, t, dt in (
        ("payload", payload, torch.uint8), ("starts", starts, torch.int64),
        ("lens", lens, torch.int32), ("bits0", bits0, torch.int32),
        ("out_offs", out_offs, torch.int64), ("out_lens", out_lens, torch.int32),
        ("cells", cells, torch.int32), ("tlogs", tlogs, torch.int32),
        ("tables", tables, torch.int16),
    ):
        if t.device != dev:
            raise ValueError(f"huf_pc_decode: {name} on {t.device}, payload on {dev}")
        if t.dtype != dt:
            raise TypeError(f"huf_pc_decode: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"huf_pc_decode: {name} must be contiguous")
    for name, t in (("lens", lens), ("bits0", bits0), ("out_offs", out_offs),
                    ("out_lens", out_lens), ("cells", cells)):
        if t.shape != (S,):
            raise ValueError(f"huf_pc_decode: {name} shape {tuple(t.shape)} != ({S},)")
    if tables.dim() != 2 or tlogs.shape != (tables.shape[0],):
        raise ValueError("huf_pc_decode: tables must be [n_cells, T], tlogs [n_cells]")
    if dev.type == "cpu":
        return huf_pc_decode_plain(
            payload, starts, lens, bits0, out_offs, out_lens, cells, tlogs,
            tables, n_out,
        )
    if dev.type != "cuda":
        raise ValueError(f"huf_pc_decode: unsupported device {dev}")
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    bits_left = torch.empty(S, dtype=torch.int32, device=dev)
    if S:
        kernels.launch(
            "huf_pc_decode", dev,
            payload.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            bits0.data_ptr(), out_offs.data_ptr(), out_lens.data_ptr(),
            cells.data_ptr(), tlogs.data_ptr(), tables.data_ptr(),
            int(tables.shape[1]), S, out.data_ptr(), bits_left.data_ptr(),
        )
    return out, bits_left


def huf_pc_decode_plain(
    payload, starts, lens, bits0, out_offs, out_lens, cells, tlogs, tables,
    n_out: int,
):
    """Plain PyTorch version: all streams advance in lockstep (the schedule
    of ``jax_entropy.decode_streams``), two symbols per step from tables
    precomputed per bit position (``_step_tables``)."""
    dev = payload.device
    S = int(starts.numel())
    out = torch.zeros(n_out, dtype=torch.uint8, device=dev)
    if S == 0:
        return out, torch.zeros(0, dtype=torch.int32, device=dev)
    i64 = torch.int64
    n = out_lens.to(i64)
    one, two = _step_tables(payload, starts, lens, cells, tlogs, tables)
    rowq = torch.arange(S, device=dev, dtype=i64) * one.shape[1]
    one, two = one.reshape(-1), two.reshape(-1)
    sym_t = (tables & 0xFF).to(torch.uint8).reshape(-1)
    nb_t = (tables >> 8).to(i64).reshape(-1)
    bl = bits0.to(i64)
    # the set of unfinished streams only changes where k passes an output
    # length, so each phase runs on a fixed subset with no per-step mask
    k = 0
    for end in sorted(set(n.tolist())):
        if end <= k:
            continue
        act = torch.nonzero(n >= end).reshape(-1)
        b = bl[act]
        rq = rowq[act]
        steps = []
        for _ in range((end - k) // 2):
            p = torch.take(two, rq + b.clamp(min=0))
            steps.append(p)
            b = b - (p >> 16)
        parts = []
        if steps:
            p = torch.stack(steps, dim=1)  # [streams, steps]
            parts.append(torch.stack([p & 0xFF, (p >> 8) & 0xFF], dim=2)
                         .flatten(1).to(torch.uint8))
        if (end - k) % 2:
            e = torch.take(one, rq + b.clamp(min=0))
            parts.append(torch.take(sym_t, e)[:, None])
            b = b - torch.take(nb_t, e)
        syms = torch.cat(parts, dim=1)
        pos = out_offs.to(i64)[act, None] + torch.arange(k, end, device=dev)
        out[pos] = syms
        bl[act] = b
        k = end
    return out, bl.to(torch.int32)


def _step_tables(payload, starts, lens, cells, tlogs, tables, block: int = 256):
    """Per stream ``s`` and bit position ``q`` (``0 <= q <= 8 * len``):

    * ``one[s, q]``: the flat index (into ``tables``) of the entry the stream
      reads at ``q``: its cell's row plus the ``tlog`` bits below ``q``, with
      zeros shifted in below the stream's first bit (the bit-window rule of
      ``jax_entropy.decode_streams``);
    * ``two[s, q]``: that symbol, the next one (read at ``max(q - nb, 0)``,
      as a step from a negative position reads at 0) and the bits both
      consume, packed ``sym1 | sym2 << 8 | nbits << 16``.

    int64 and int32 [S, 8 * max_len + 1]; built ``block`` streams at a time
    to bound the temporaries.
    """
    dev = payload.device
    i64 = torch.int64
    S = int(starts.numel())
    L = lens.to(i64)
    Lmax = int(L.max())
    Q = 8 * Lmax + 1
    tl = tlogs.to(i64)[cells.to(i64)]
    row = cells.to(i64) * int(tables.shape[1])
    sym_t = (tables & 0xFF).to(i64).reshape(-1)
    nb_t = (tables >> 8).to(i64).reshape(-1)
    one = torch.empty((S, Q), dtype=i64, device=dev)
    two = torch.empty((S, Q), dtype=torch.int32, device=dev)
    pos = torch.arange(Lmax + 3, device=dev, dtype=i64)
    q = torch.arange(Q, device=dev, dtype=i64)[None, :]
    for s0 in range(0, S, block):
        sl = slice(s0, min(S, s0 + block))
        inside = pos[None, :] < L[sl, None]
        at = (starts[sl].to(i64)[:, None] + pos[None, :]).clamp(max=payload.numel() - 1)
        sb = torch.where(inside, payload[at].to(i64), 0)
        # stream bytes b, b+1, b+2 as one little-endian value
        win3 = sb[:, :-2] | (sb[:, 1:-1] << 8) | (sb[:, 2:] << 16)
        lo = q - tl[sl, None]
        lo2 = lo.clamp(min=0)
        navail = (q - lo2).clamp(0, 12)
        win = win3.gather(1, (lo2 >> 3).expand(win3.shape[0], -1))
        val = (win >> (lo2 & 7)) & ((1 << navail) - 1)
        e1 = (val << (lo2 - lo).clamp(max=12)) + row[sl, None]
        nb1 = nb_t[e1]
        e2 = e1.gather(1, (q - nb1).clamp(min=0))
        one[sl] = e1
        two[sl] = (sym_t[e1] | (sym_t[e2] << 8) | ((nb1 + nb_t[e2]) << 16)).to(torch.int32)
    return one, two
