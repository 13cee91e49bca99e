"""Chunk-range sharding of the codec over several devices of one process.

The counterpart of the JAX package's ``parallel/sharded.py``.  The format
is chunk-parallel by construction: every (plane, chunk) cell is an
independent stream with a known output offset.  There the chunk and
stream axes are ``shard_map``\\ ped over a ``jax.sharding.Mesh``; here a
:class:`Mesh` lists the devices (``torch.device``), and each stage splits
its independent axis into contiguous ranges by :func:`chunk_range`'s rule,
copies each range's inputs to its device, replicates the read-only tables
there and launches the kernel on that device's current stream.  No stage
needs a collective; the results come back in order.

The mesh is ambient (:func:`use_mesh`): with one set, ``ops.encode.start``
and ``ops.decode.start`` split each batch's chunks the same way, so every
caller above them (``ZipNN``, ``ShardDecoder``, ``ShardEncoder``, the
loaders, the CLI) runs sharded with no change.  A mesh may list one
device more than once: each entry is one shard, so one card runs a
2-shard mesh as two launches of half the size (the JAX package gets the
same from XLA's virtual CPU devices).

Usage::

    mesh = parallel.make_mesh()            # every CUDA device
    with parallel.use_mesh(mesh):
        ZipNN(engine="cuda").compress(...)  # kernels split over the mesh
"""
from __future__ import annotations

import contextlib
import math
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

_DEFAULT_MESH = None


def chunk_range(process_id: int, n_processes: int, n_chunks: int) -> Tuple[int, int]:
    """Contiguous chunk range [lo, hi) of one of ``n_processes`` parts;
    deterministic and balanced (the first ``n_chunks % n`` parts take one
    chunk more)."""
    base, extra = divmod(n_chunks, n_processes)
    lo = process_id * base + min(process_id, extra)
    return lo, lo + base + (1 if process_id < extra else 0)


def canonical(device) -> torch.device:
    """``device`` with its index: ``"cuda"`` is the current CUDA device,
    so it compares equal to the device its tensors report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Devices in a grid: ``devices`` (a numpy object array of
    ``torch.device``), ``axis_names`` and ``shape`` (axis name -> size, as
    a ``jax.sharding.Mesh`` gives it).  Each entry is one shard."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims with axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> List[torch.device]:
        """The shards' devices, in order."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {[str(d) for d in self.flat()]})"


def make_mesh(devices: Optional[Sequence] = None,
              axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """A :class:`Mesh` over ``devices`` (``torch.device`` or strings; one
    may repeat), by default every CUDA device (raises when there is none:
    a mesh never falls back to the CPU).

    With 4 or more entries and an even count the mesh is 2-D ``("host",
    "chip")``, ``host`` the largest divisor of the count up to its square
    root; otherwise 1-D ``("chip",)``: the JAX package's rule.
    """
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device (pass devices=[...] for others)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: a CUDA device was listed but CUDA is not available")
    devices = [canonical(d) for d in devices]
    if axis_names is None:
        axis_names = ("host", "chip") if n >= 4 and n % 2 == 0 else ("chip",)
    if len(axis_names) == 2:
        hosts = max(d for d in range(1, math.isqrt(n) + 1) if n % d == 0)
        shape: Tuple[int, ...] = (hosts, n // hosts)
    else:
        shape = (n,)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names)


def get_default_mesh() -> Optional[Mesh]:
    return _DEFAULT_MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Split the codec's kernels over ``mesh`` within the block."""
    global _DEFAULT_MESH
    prev = _DEFAULT_MESH
    _DEFAULT_MESH = mesh
    try:
        yield mesh
    finally:
        _DEFAULT_MESH = prev


def _ranges(mesh: Mesh, n: int, group: int = 1) -> List[Tuple[torch.device, int, int]]:
    """``(device, lo, hi)`` of each non-empty part of ``n`` items over the
    mesh's entries, in order: :func:`chunk_range`'s rule over whole groups
    of ``group`` items (the last group may be short)."""
    out = []
    for j, dev in enumerate(mesh.flat()):
        a, b = chunk_range(j, mesh.size, -(-n // group))
        a, b = a * group, min(n, b * group)
        if b > a:
            out.append((dev, a, b))
    return out


def shards(lo: int, hi: int, device, align: int = 1) -> List[Tuple[torch.device, int, int]]:
    """``(device, lo, hi)`` of each non-empty shard of chunks [lo, hi)
    under the ambient mesh, in order, each starting a whole number of
    ``align`` chunks from ``lo``; ``[(device, lo, hi)]`` with no mesh."""
    if _DEFAULT_MESH is None:
        return [(canonical(device), lo, hi)]
    return [(dev, lo + a, lo + b) for dev, a, b in _ranges(_DEFAULT_MESH, hi - lo, align)]


def _on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def _gather(parts: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """The shards' results in order on ``like``'s device."""
    if not parts:
        return like.new_empty((0,) + tuple(like.shape[1:]))
    return torch.cat([_on(p, like.device) for p in parts])


# ---------------------------------------------------------------------------
# entropy stages: shard the stream axis (a cell's 4 streams together)
# ---------------------------------------------------------------------------

def sharded_decode_streams(mesh: Mesh, payload, starts, lens, bits0, out_offs, out_lens,
                           n_out: int, tables=None, cells=None, tlogs=None, table8=None):
    """The decode kernel over streams split on ``mesh``: K6
    (``huf_shared.huf_shared_decode``) with ``table8``, else K1
    (``huf_pc.huf_pc_decode``) with ``cells``, ``tlogs`` and ``tables``;
    arguments as theirs.  The payload and the tables are replicated; each
    shard writes its streams into its own symbol buffer, and the symbols
    come back at their ``out_offs`` in one buffer of ``n_out`` bytes on the
    payload's device, with every stream's ``bits_left`` in order."""
    from ..ops import huf_pc, huf_shared  # noqa: PLC0415

    out = torch.zeros(n_out, dtype=torch.uint8, device=payload.device)
    bits = []
    for dev, a, b in _ranges(mesh, int(starts.numel()), 4):
        offs = out_offs[a:b]
        base = int(offs.min()) if b > a else 0
        top = int((offs + out_lens[a:b]).max()) if b > a else 0
        args = [_on(t[a:b], dev) for t in (starts, lens, bits0)]
        args += [_on(offs - base, dev), _on(out_lens[a:b], dev)]
        if table8 is not None:
            sym, bl = huf_shared.huf_shared_decode(_on(payload, dev), *args, _on(table8, dev),
                                                   top - base)
        else:
            sym, bl = huf_pc.huf_pc_decode(_on(payload, dev), *args, _on(cells[a:b], dev),
                                           _on(tlogs, dev), _on(tables, dev), top - base)
        # every symbol position of the shard's streams, in its own buffer
        n = out_lens[a:b].to(torch.int64)
        first = torch.repeat_interleave(offs - base - (torch.cumsum(n, 0) - n), n)
        pos = first + torch.arange(int(n.sum()), device=first.device)
        out[base + pos] = _on(sym, out.device)[pos]
        bits.append(bl)
    return out, _gather(bits, bits0.to(torch.int32))


def sharded_encode_streams(mesh: Mesh, planes, seg: int, streams, table=None, tables=None):
    """The encode kernel over streams split on ``mesh``: K7
    (``huf_enc.huf_shared_encode``) with one ``table``, else E
    (``huf_enc.huf_pc_encode``) with a row of ``tables`` per cell;
    arguments as theirs.  ``planes`` and the shared table are replicated;
    returns (rows, total_bits) in stream order on ``planes``' device."""
    from ..ops import huf_enc  # noqa: PLC0415

    rows, bits = [], []
    for dev, a, b in _ranges(mesh, int(streams.numel()), 4):
        p, s = _on(planes, dev), _on(streams[a:b], dev)
        if table is not None:
            r, tb = huf_enc.huf_shared_encode(p, _on(table, dev), seg, s)
        else:
            r, tb = huf_enc.huf_pc_encode(p, _on(tables[a // 4 : b // 4], dev), seg, s)
        rows.append(r)
        bits.append(tb)
    width = huf_enc.row_words(seg, huf_enc.TMAX if table is not None else huf_enc.PC_TMAX)
    like = planes.new_empty((0, width))
    return _gather(rows, like), _gather(bits, planes.new_empty(0))


def sharded_histogram(mesh: Mesh, rows):
    """``hist.hist_cells`` (H) with its cells (rows) split over ``mesh``."""
    from ..ops import hist  # noqa: PLC0415

    parts = [hist.hist_cells(_on(rows[a:b], dev)) for dev, a, b in _ranges(mesh, rows.shape[0])]
    return _gather(parts, rows.new_empty((0, 256)))


# ---------------------------------------------------------------------------
# transform stages: shard the chunk axis
# ---------------------------------------------------------------------------

def sharded_split(mesh: Mesh, words, num_buf: int, byte_reorder: int, bit_reorder: int):
    """``transforms.split_device`` with its chunks (rows of ``words``)
    split over ``mesh``."""
    from ..ops import transforms  # noqa: PLC0415

    parts = [transforms.split_device(_on(words[a:b], dev), num_buf, byte_reorder, bit_reorder)
             for dev, a, b in _ranges(mesh, words.shape[0])]
    return _gather(parts, words.new_empty((0, num_buf, words.shape[1] // num_buf)))


def sharded_combine(mesh: Mesh, payload, hsym, kinds, srcs, hsym_row: int, chunk_size: int,
                    total_bytes: int, num_buf: int, byte_reorder: int, bit_reorder: int, out):
    """K2 (``combine.combine_cells``) with its chunks split over ``mesh``;
    arguments as its.  The payload and symbol rows are replicated; each
    shard assembles its chunks on its device, and they are written into
    ``out`` in place.  Returns ``out``."""
    from ..ops import combine  # noqa: PLC0415

    n_chunks = -(-total_bytes // chunk_size)
    align = 4 // math.gcd(chunk_size, 4)  # each shard's output on a word boundary
    for dev, lo, hi in _ranges(mesh, n_chunks, align):
        total = min(hi * chunk_size, total_bytes) - lo * chunk_size
        dst = out[lo * chunk_size :] if dev == out.device else torch.empty(
            -(-total // 4) * 4, dtype=torch.uint8, device=dev)
        combine.combine_cells(_on(payload, dev), _on(hsym, dev),
                              _on(kinds[lo * num_buf : hi * num_buf], dev),
                              _on(srcs[lo * num_buf : hi * num_buf], dev), hsym_row,
                              chunk_size, total, num_buf, byte_reorder, bit_reorder, dst)
        if dev != out.device:
            out[lo * chunk_size : lo * chunk_size + total].copy_(dst[:total])
    return out
