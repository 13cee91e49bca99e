"""Shared-table Huffman decode: host table prep, the CUDA kernel's wrapper
and its plain PyTorch version.

The counterpart of the JAX package's ``ops/pallas_huf.py``.  A
shared-table container (what ``huffman_table="shared"`` writes) repeats
one weight header with tableLog <= 8 in every Huffman cell, so one table
serves every stream.  The kernel (``csrc/huf_shared.cu``) decodes one
stream per warp by the self-synchronising schedule that ``huf_sync``
models (one per lane where streams are short), straight from the uploaded
payload, with the table in shared
memory, and writes symbol bytes; the TPU's row gather (K3) has no
counterpart here.

Table layout: 256 uint16 entries ``symbol | nb_bits << 8`` indexed by the
8 stream bits below the cursor.  Entry ``x`` is the decode table's entry
``x >> (8 - tableLog)`` (``pallas_huf.expand_dtable8``'s layout), so a
peek of 8 bits decodes any tableLog <= 8.  Torch has no uint16 arithmetic
on the CPU, so the table is an int16 tensor (entries < 2^12).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import huf_pc, kernels
from .entropy import huf

# a launch whose streams average fewer symbols decodes one stream per lane
# (``huf_pc.streams_per_warp``); higher than K1's, since K6's lanes read
# the table from shared memory, K1's their cell's row from device memory
# (the crossovers measured by time_kernels.py)
GROUP_SYMBOLS = 2048

TMAX = 8  # the largest tableLog one 256-entry table expands

# the kernel's per-stream synchronisation passes of the last CUDA call
# (int32 [S] on the card; -1 where a capped loop sent a stream to the
# serial chain, 0 for a lane per stream); None after a CPU call
last_sync_passes: Optional[torch.Tensor] = None


def expand_table8(header: bytes) -> np.ndarray:
    """Parse one weight header into the kernel's 256-entry table (int16).

    Raises ValueError on a corrupt header, on tableLog > 8 and on a table
    with unpopulated entries.
    """
    weights, rank_stats, tlog, _, _ = huf.read_stats(header)
    if tlog > TMAX:
        raise ValueError(f"table_log {tlog} > {TMAX}")
    sym_t, nb_t = huf.build_dtable(weights, rank_stats, tlog)
    if np.any(nb_t[: 1 << tlog] == 0):
        raise ValueError("dtable has unpopulated entries (corrupt weights)")
    idx8 = np.arange(256) >> (TMAX - tlog)
    return sym_t[idx8].astype(np.int16) | (nb_t[idx8].astype(np.int16) << 8)


def huf_shared_decode(
    payload: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    bits0: torch.Tensor,
    out_offs: torch.Tensor,
    out_lens: torch.Tensor,
    table: torch.Tensor,
    n_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode S streams with one shared table into one uint8 buffer of
    ``n_out`` bytes.

    Stream ``s`` covers payload bytes ``[starts[s], starts[s] + lens[s])``,
    starts at bit ``bits0[s]`` and writes ``out_lens[s]`` symbols at
    ``out_offs[s]``; ``table`` is :func:`expand_table8`'s 256 entries.
    Returns (out uint8 [n_out], bits_left int32 [S]); a stream decoded
    exactly ends with ``bits_left == 0``.  Bytes of ``out`` that no stream
    covers are undefined.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which also leaves its per-stream sync passes in ``last_sync_passes``.
    """
    global last_sync_passes
    dev = payload.device
    S = int(starts.numel())
    for name, t, dt in (
        ("payload", payload, torch.uint8), ("starts", starts, torch.int64),
        ("lens", lens, torch.int32), ("bits0", bits0, torch.int32),
        ("out_offs", out_offs, torch.int64), ("out_lens", out_lens, torch.int32),
        ("table", table, torch.int16),
    ):
        if t.device != dev:
            raise ValueError(f"huf_shared_decode: {name} on {t.device}, payload on {dev}")
        if t.dtype != dt:
            raise TypeError(f"huf_shared_decode: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"huf_shared_decode: {name} must be contiguous")
    for name, t in (("lens", lens), ("bits0", bits0), ("out_offs", out_offs),
                    ("out_lens", out_lens)):
        if t.shape != (S,):
            raise ValueError(f"huf_shared_decode: {name} shape {tuple(t.shape)} != ({S},)")
    if table.shape != (256,):
        raise ValueError(f"huf_shared_decode: table shape {tuple(table.shape)} != (256,)")
    if dev.type == "cpu":
        last_sync_passes = None
        return huf_shared_decode_plain(
            payload, starts, lens, bits0, out_offs, out_lens, table, n_out,
        )
    if dev.type != "cuda":
        raise ValueError(f"huf_shared_decode: unsupported device {dev}")
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    bits_left = torch.empty(S, dtype=torch.int32, device=dev)
    passes = torch.empty(S, dtype=torch.int32, device=dev)
    if S:
        kernels.launch(
            "huf_shared_decode", dev,
            payload.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            bits0.data_ptr(), out_offs.data_ptr(), out_lens.data_ptr(),
            table.data_ptr(), S, huf_pc.LANES, huf_pc.MIN_SEG_BITS,
            huf_pc.streams_per_warp(n_out, S, GROUP_SYMBOLS),
            out.data_ptr(), bits_left.data_ptr(), passes.data_ptr(),
        )
    last_sync_passes = passes
    return out, bits_left


def huf_shared_decode_plain(
    payload, starts, lens, bits0, out_offs, out_lens, table, n_out: int,
):
    """Plain PyTorch version: the per-cell decode's lockstep schedule
    (``huf_pc.huf_pc_decode_plain``) with every stream on the one table,
    read as a tableLog-8 table (an 8-bit peek of the expanded table is the
    tableLog-bit peek of the original)."""
    dev = payload.device
    S = int(starts.numel())
    return huf_pc.huf_pc_decode_plain(
        payload, starts, lens, bits0, out_offs, out_lens,
        torch.zeros(S, dtype=torch.int32, device=dev),
        torch.full((1,), TMAX, dtype=torch.int32, device=dev),
        table.reshape(1, 256), n_out,
    )
