"""Back-to-back shard decode for serving loads, and encode for checkpoint
saves.

The port of the JAX package's ``io/serving.py``.  A model load
decompresses many containers in a row (one per tensor in the per-tensor
safetensors schema); one ``ZipNN.decompress`` at a time pays each
container's host plan, uploads and validation fetch in turn.
:class:`ShardDecoder` overlaps them on the card:

* ``decode.start`` of container N+1 (its host plan, its copies into
  pinned memory and their DMA on the copy stream, its kernels queued
  behind them) runs while container N's kernels run; ``finish`` then
  fetches container N's ``bits_left``;
* :meth:`ShardDecoder.stage` does the plan and every upload ahead of
  time, so :meth:`ShardDecoder.start_staged` only queues kernels;
* :meth:`ShardDecoder.decompress_all` defers every container's
  end-of-stream check to one fetch for the whole load.

Usage::

    from zipnn_tpu_torch.io.serving import ShardDecoder
    dec = ShardDecoder(to_device=True)          # uint8 CUDA tensors
    for out in dec.decompress_iter(blobs):
        ...

Containers may be byte-format frames, byte-format streaming containers
(their frames decoded on the card together, ``decode.frame_runs``) or
torch/numpy-format frames (with a shape after the header); the decoder
always yields the flat decompressed bytes (a lossy container's after its
int-to-float step), and the caller reapplies dtype and shape.

A checkpoint save compresses many tensors in a row: :class:`ShardEncoder`
finishes container N (its tail cells, its tables and the fetch of its
payload from the card) while container N+1's kernels run::

    from zipnn_tpu_torch import ZipNN
    from zipnn_tpu_torch.io.serving import ShardEncoder
    enc = ShardEncoder(ZipNN(input_format="torch", engine="cuda"), pool_staging=True)
    with open(path, "wb") as f:
        for frame in enc.compress_iter(tensors):
            f.write(frame)
"""
from __future__ import annotations

import threading
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from .. import codec, stats
from ..core import dtypes
from ..core.enums import EnumFormat, EnumLossy
from ..core.header import HEADER_LEN, Header
from ..ops import decode, encode
from ..zipnn import VANILLA_BYTE_REORDERS, ZipNN, lossy_to_float

__all__ = ["ShardDecoder", "ShardEncoder", "decompress_iter"]


class _Started:
    """In-flight container: its kernels queued, ``finish()`` drains."""

    __slots__ = ("finish", "out", "hdr")

    def __init__(self, finish, out, hdr):
        self.finish = finish
        self.out = out
        self.hdr = hdr


class _StagedShard:
    """A staged container: its header, its ``decode.Staged`` (plan and
    every device input uploaded) and the bytes those inputs hold."""

    __slots__ = ("hdr", "staged", "upload_bytes")

    def __init__(self, hdr, staged, upload_bytes):
        self.hdr, self.staged, self.upload_bytes = hdr, staged, upload_bytes


class _Stack:
    """Staged shards that :meth:`ShardDecoder.decompress_stacked` runs
    back to back, with one deferred validation."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = list(shards)


class ShardDecoder:
    """Cross-container pipelined decoder on ``device`` (the card unless the
    caller passes ``device="cpu"``, where the kernels' plain versions run).

    ``to_device=True`` yields a uint8 tensor on ``device`` per container,
    the view ``decode.finish`` returns (retype it with ``.view(dtype)``);
    otherwise ``bytes``, or owned writable uint8 numpy arrays under
    ``as_numpy``, decoded on ``device`` and fetched.

    Every container decodes on ``device``, including those with no full
    chunk (a norm weight) and a streaming container's frames (one run of
    them: every frame that ``ZipNN.compress`` writes); there is no host
    route.  A lossy container yields its float bytes, turned from integers
    on ``device``.  Delta containers, and streaming containers with a
    tensor input format, raise the reference's ``ValueError``; so do
    whole-buffer method (zstd/lz4/snappy) containers, which decode on the
    host, and streaming containers whose frames lie on more than one chunk
    grid: ``ZipNN.decompress`` decodes both.  ``timings`` holds the phase
    seconds (``plan_s``, ``stage_s``, ``upload_s``; see
    ``decode.last_timings``) of each container of the last call, in order.
    """

    def __init__(self, to_device: bool = False, as_numpy: bool = False, device="cuda"):
        self.to_device = to_device
        self.as_numpy = as_numpy
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ShardDecoder with device='cuda' needs a CUDA device; pass "
                "device='cpu' to run the kernels' plain versions")
        self.timings: List[dict] = []

    # -- per-container phases ------------------------------------------
    def _plan_container(self, data):
        """Parse one container's header; returns (header, the arguments of
        ``decode.start`` / ``decode.stage`` but ``device``, and their
        ``frames``: a streaming container's run, else None)."""
        mv = memoryview(data)
        if len(mv) < HEADER_LEN or bytes(mv[0:2]) != b"ZN":
            raise ValueError("Header should start with ZN")
        # torch/numpy frames carry a packed shape after the 32-byte header;
        # ``consumed`` skips it, so the payload slice is format-independent
        hdr, consumed = Header.from_bytes(mv)
        if hdr.delta_mode:
            raise ValueError(
                "delta containers need delta_second_data; use ZipNN.decompress"
            )
        vanilla = hdr.byte_reorder in VANILLA_BYTE_REORDERS
        if (hdr.is_streaming or vanilla) and hdr.input_format != EnumFormat.BYTE.value:
            raise ValueError(
                "streaming/vanilla containers with a tensor input format "
                "need their frontend marshalling; use ZipNN.decompress"
            )
        if hdr.is_streaming:
            runs = decode.frame_runs(mv, VANILLA_BYTE_REORDERS)
            if len(runs) == 1 and runs[0].frames is not None:
                return hdr, (mv, *runs[0].key, runs[0].orig_size), runs[0].frames
        if vanilla or hdr.is_streaming:
            raise ValueError(
                "whole-buffer method frames, and streaming frames on more than "
                "one chunk grid, decode through ZipNN.decompress"
            )
        total = hdr.total_len if 0 < hdr.total_len <= len(mv) else len(mv)
        num_buf = dtypes.groups_for_decompress(hdr.dtype_code)
        chunk = codec.effective_chunk(hdr.compression_chunk, num_buf)
        return hdr, (mv[consumed:total], num_buf, hdr.bit_reorder, hdr.byte_reorder,
                     chunk, hdr.original_len), None

    def _finisher(self, run, hdr):
        self.timings.append(run.timings)
        if hdr.lossy_type == EnumLossy.INTEGER.value and hdr.lossy_is_int:
            return lambda: self._marshal(lossy_to_float(
                decode.finish(run), hdr.dtype_code, hdr.lossy_factor).view(torch.uint8))
        return lambda: self._marshal(decode.finish(run))

    def start(self, data, defer=None) -> _Started:
        """Host plan, uploads and kernel launches of one container; the
        handle's ``finish()`` yields its output.  ``defer`` (a list) skips
        the container's validation fetch: see :meth:`decompress_all`."""
        hdr, args, frames = self._plan_container(data)
        run = decode.start(*args, device=self.device, defer=defer, frames=frames)
        return _Started(self._finisher(run, hdr), run.out, hdr)

    def stage(self, data) -> _StagedShard:
        """Parse, plan and upload every device input of one container, for
        :meth:`start_staged`, which copies nothing to the card."""
        hdr, args, frames = self._plan_container(data)
        st = decode.stage(*args, device=self.device, frames=frames)
        return _StagedShard(hdr, st, st.inputs.nbytes if st.inputs else 0)

    def start_staged(self, st: _StagedShard, defer=None) -> _Started:
        """Queue the kernels of a :meth:`stage`\\ d container (any number of
        times)."""
        run = decode.start_staged(st.staged, defer=defer)
        return _Started(self._finisher(run, st.hdr), run.out, st.hdr)

    def _marshal(self, flat: torch.Tensor):
        if self.to_device:
            return flat
        host = np.empty(flat.numel(), dtype=np.uint8)
        torch.from_numpy(host).copy_(flat)
        return host if self.as_numpy else host.tobytes()

    # -- pipelined iteration --------------------------------------------
    def decompress_iter(self, blobs: Iterable, depth: int = 2) -> Iterator:
        """Decode ``blobs`` in order, keeping up to ``depth`` containers in
        flight: container N+1's plan, uploads and launches overlap
        container N's kernels."""
        self.timings = []
        inflight: List[_Started] = []
        for blob in blobs:
            inflight.append(self.start(blob))
            if len(inflight) >= depth:
                yield inflight.pop(0).finish()
        while inflight:
            yield inflight.pop(0).finish()

    def decompress(self, data):
        """Single-container convenience (no pipelining)."""
        self.timings = []
        return self.start(data).finish()

    # -- staged bundles --------------------------------------------------
    def stack(self, staged_list) -> Optional[_Stack]:
        """Bundle staged shards for :meth:`decompress_stacked`; None when
        one of them is not a :meth:`stage` handle."""
        if not all(isinstance(s, _StagedShard) for s in staged_list):
            return None
        return _Stack(staged_list)

    def _need_owned_output(self, what: str) -> None:
        if not (self.to_device or self.as_numpy):
            raise ValueError(f"{what} needs to_device=True or as_numpy=True")

    def decompress_stacked(self, stk_or_list) -> Optional[list]:
        """Decode a :meth:`stack` bundle (or stack a staged list inline):
        its shards' staged launches back to back, validated by one fetch;
        returns per-shard outputs in order, or None when not stackable.
        A ``znn:decode:stacked`` span (``stats.phase``) holds the call, a
        ``znn:decode:enqueue`` span each shard's launches."""
        self._need_owned_output("decompress_stacked")
        stk = stk_or_list
        if isinstance(stk, (list, tuple)):
            stk = self.stack(stk)
        if stk is None:
            return None
        with stats.phase("decode:stacked"):
            self.timings = []
            defer: list = []
            outs = []
            for s in stk.shards:
                with stats.phase("decode:enqueue"):
                    outs.append(self.start_staged(s, defer=defer).finish())
            self._validate_deferred([defer])
        return outs

    # -- bulk decode with deferred validation ----------------------------
    def decompress_all(self, items, depth: int = 4) -> list:
        """Decode many containers, validating all of them in one fetch at
        the end: every container's kernels run back to back.  ``items`` may
        mix bytes-like containers and :meth:`stage` handles.  Needs device
        or numpy output (``to_device`` / ``as_numpy``), as the reference's
        does."""
        self._need_owned_output("decompress_all")
        return self.decompress_groups(self.stack_groups(items), depth=depth)

    def stack_groups(self, items) -> list:
        """Group ``items`` into execution units: each run of two or more
        consecutive :meth:`stage` handles is one bundle, anything else a
        unit of its own.  The list replays through
        :meth:`decompress_groups` any number of times; its staged units
        copy nothing to the card again."""
        items = list(items)
        units: list = []
        i = 0
        while i < len(items):
            j = i
            while j < len(items) and isinstance(items[j], _StagedShard):
                j += 1
            if j - i >= 2:
                units.append(("stk", _Stack(items[i:j]), list(range(i, j))))
                i = j
                continue
            units.append(("one", items[i], i))
            i += 1
        units.append(("n", len(items)))
        return units

    def decompress_groups(self, units, depth: int = 4) -> list:
        """Execute a :meth:`stack_groups` plan: launches, up to ``depth``
        containers in flight, and one validation fetch."""
        self._need_owned_output("decompress_groups")
        self.timings = []
        n = units[-1][1]
        defers: list = [[] for _ in range(n)]
        outs: list = [None] * n
        inflight: list = []
        for unit in units[:-1]:
            if unit[0] == "stk":
                _kind, stk, idxs = unit
                for s, gi in zip(stk.shards, idxs):
                    outs[gi] = self.start_staged(s, defer=defers[gi]).finish()
                continue
            _kind, it, i = unit
            if isinstance(it, _StagedShard):
                inflight.append((i, self.start_staged(it, defer=defers[i])))
            else:
                inflight.append((i, self.start(it, defer=defers[i])))
            if len(inflight) >= depth:
                j, h = inflight.pop(0)
                outs[j] = h.finish()
        while inflight:
            j, h = inflight.pop(0)
            outs[j] = h.finish()
        self._validate_deferred(defers)
        return outs

    def _validate_deferred(self, defers) -> None:
        """One fetch of every deferred container's ``bits_left`` (in order:
        the first bad container raises its own ``CorruptChunkError``); the
        fetch follows every launch on the compute stream, so the outputs
        are complete when it returns."""
        decode.validate_deferred([e for d in defers for e in d])


def decompress_iter(blobs: Iterable, to_device: bool = False, device="cuda") -> Iterator:
    """Module-level convenience: ``ShardDecoder(to_device, device=device)
    .decompress_iter``."""
    return ShardDecoder(to_device=to_device, device=device).decompress_iter(blobs)


# ---------------------------------------------------------------------------
# encode: the output pool of pool_staging, and ShardEncoder
# ---------------------------------------------------------------------------

OUT_POOL_BYTES = 2 << 30  # bytes of free output buffers the process keeps
_OUT_ROUND = 1 << 20  # output buffers are whole MiB, so sizes near each other share them
_out_pool: List[torch.Tensor] = []
_out_lock = threading.Lock()


def _out_acquire(need: int, pinned: bool) -> torch.Tensor:
    """A uint8 host buffer of at least ``need`` bytes from the pool (the
    smallest that fits, page-locked or not as asked), else a new one, its
    pages touched once: the counterpart of the JAX package's
    ``_stage_pool_acquire``."""
    with _out_lock:
        fits = [i for i, b in enumerate(_out_pool)
                if b.numel() >= need and b.is_pinned() == pinned]
        if fits:
            return _out_pool.pop(min(fits, key=lambda i: _out_pool[i].numel()))
    size = max(_OUT_ROUND, -(-need // _OUT_ROUND) * _OUT_ROUND)
    buf = torch.empty(size, dtype=torch.uint8, pin_memory=pinned)
    buf.numpy()[::4096] = 0
    return buf


def _out_release(bufs) -> None:
    """Give buffers back to the pool, dropping the oldest beyond
    ``OUT_POOL_BYTES``: the counterpart of ``_stage_pool_release``."""
    with _out_lock:
        _out_pool.extend(bufs)
        while _out_pool and sum(b.numel() for b in _out_pool) > OUT_POOL_BYTES:
            _out_pool.pop(0)


class _PendingEnc:
    """In-flight compress: its kernels queued and its cells decided and
    written on the card; ``finish()`` returns its container."""

    __slots__ = ("finish",)

    def __init__(self, finish):
        self.finish = finish


class ShardEncoder:
    """Pipelined multi-container compress: the encode twin of
    :class:`ShardDecoder`.

    One ``ZipNN.compress`` at a time runs each container's phases in turn:
    the device encode (split, histograms, Huffman kernels, the cells
    written on the card) and the host's share (the tail cells, the output
    and its tables, the payload fetched through pinned memory).  Here
    container N+1's start (``ZipNN._start_payload``: ``ops.encode.start``
    on ``engine="cuda"``) queues its first kernels, then finishes container
    N through its ``between`` hook before its first host sync, so the card
    runs N+1's kernels while the host finishes N.  Both profiles take this
    path; the containers are byte-identical to ``ZipNN.compress`` (the
    same ``start`` / ``finish``).  A ``zipnn`` of another engine
    (``numpy``, ``native``) computes each payload at its start.

    ``zipnn`` defaults to ``ZipNN(engine="cuda", huffman_table="shared",
    device=device)``, the reference's default profile; the card unless the
    caller passes ``device="cpu"``, where the kernels' plain versions run.
    Byte-format input takes bytes-like buffers; pass a
    ``ZipNN(input_format="torch", ...)`` for tensors (a CUDA tensor is
    read in place).  A lossy ``zipnn`` takes the same path; a streaming one
    compresses each buffer through ``ZipNN.compress`` (frame by frame), as
    does a whole-buffer method; a delta ``zipnn`` is refused here, since
    ``compress_iter`` has no second buffer to XOR with.

    ``pool_staging=True`` writes each container into a host buffer from a
    bounded per-process pool (``OUT_POOL_BYTES``; page-locked on a CUDA
    device, so the payload's fetch is one DMA straight into it) instead of
    a new ``bytes``.  The yielded containers are then memoryviews into
    pooled buffers, each valid until two further containers have been
    yielded: consume (write or copy) each as it arrives, which is what a
    checkpoint writer does.  :meth:`compress_all` copies them into owned
    ``bytes``.  With the default ``pool_staging=False`` every container is
    a ``bytes`` of its own.  ``timings`` holds each container's
    ``ops.encode.last_timings`` of the last call, in order.
    """

    def __init__(self, zipnn: Optional[ZipNN] = None, pool_staging: bool = False,
                 device="cuda"):
        if zipnn is None:
            zipnn = ZipNN(engine="cuda", huffman_table="shared", device=device)
        if zipnn.delta_compressed_type not in (None, 0, "0"):
            raise NotImplementedError(
                "ShardEncoder takes no delta ZipNN: compress_iter has no "
                "delta_second_data; use ZipNN.compress(data, delta_second_data=...)"
            )
        self._z = zipnn
        self._pool = pool_staging
        self._held: List[torch.Tensor] = []  # pooled buffers of yielded containers
        self.timings: List[dict] = []

    def _input(self, staged, arr, hdr):
        """The bytes to encode: ``arr``, or ``staged``, a uint8 tensor on
        the encoder's device holding the same bytes (engine ``cuda``).  A
        lossy container that stores integers encodes ``arr``, the scaled
        integers, never the buffer's own (float) bytes in ``staged``."""
        if staged is None or self._z.engine != "cuda" or hdr.lossy_is_int:
            return arr
        n = arr.numel() if isinstance(arr, torch.Tensor) else arr.size
        if (not isinstance(staged, torch.Tensor) or staged.dtype != torch.uint8
                or staged.numel() != n):
            raise ValueError(f"staged words must be a uint8 tensor of the buffer's {n} bytes")
        return staged.reshape(-1)

    def _submit(self, data, between=None, staged=None) -> _PendingEnc:
        """Prepare one container and queue its device work.  ``between``
        (optional) is called exactly once: after this container's first
        launch, before its first host sync (at once on a container with no
        launch, or when the preparation raises)."""
        z = self._z
        fire = encode.Between(between)
        if z.is_streaming and z.input_format == EnumFormat.BYTE.value:
            fire()
            return _PendingEnc(lambda: self._untimed(z.compress(data)))
        try:
            prep = z._compress_prepare(data)
            if prep[0] == "vanilla":
                fire()
                return _PendingEnc(lambda: self._untimed(prep[1]))
            _, hdr, arr, grouping, chunk, prefix = prep
            started = z._start_payload(self._input(staged, arr, hdr), grouping, chunk, prefix,
                                       between=fire)
        except BaseException:
            fire()
            raise
        fire()

        def fin():
            owned: List[torch.Tensor] = []

            def alloc(n: int) -> np.ndarray:
                owned.append(_out_acquire(n, z.device.type == "cuda"))
                return owned[-1][:n].numpy()

            try:
                payload = codec.finish_payload(started, alloc if self._pool else codec.frame)
            except BaseException:
                _out_release(owned)
                raise
            frame = z._compress_finish(hdr, payload, prefix, hdr.original_len)
            self.timings.append(dict(encode.last_timings) if z.engine == "cuda" else {})
            if not owned:
                return codec.frame_bytes(frame)
            self._track_pooled(owned[0])
            return memoryview(frame)

        return _PendingEnc(fin)

    def _untimed(self, container: bytes) -> bytes:
        """A container that no device encode made: no timings of its own."""
        self.timings.append({})
        return container

    def _track_pooled(self, buf: torch.Tensor) -> None:
        # a pooled buffer returns to the pool two yields after its
        # container was produced (the documented validity window)
        self._held.append(buf)
        while len(self._held) > 2:
            _out_release([self._held.pop(0)])

    def _release_held(self) -> None:
        _out_release(self._held)
        self._held = []

    # -- pipelined iteration ---------------------------------------------
    def compress_iter(self, buffers: Iterable, staged_words=None) -> Iterator:
        """Compress ``buffers`` in order, one container per buffer, each
        container finished while the next one's kernels run.
        ``staged_words`` optionally supplies, in parallel, each buffer's
        bytes already on the card (uint8 tensors, read in place); a None
        entry, or an iterable shorter than ``buffers``, leaves the buffer
        to the encoder's own upload, and a lossy ``zipnn`` that scales the
        buffer to integers encodes those, not its staged words.  An early exit or an error returns
        every pooled buffer this encoder holds to the pool."""
        self.timings = []
        done: list = []
        prev: Optional[_PendingEnc] = None
        words = iter(staged_words) if staged_words is not None else None
        try:
            for b in buffers:
                staged = next(words, None) if words is not None else None
                if prev is None:
                    h = self._submit(b, staged=staged)
                else:
                    p = prev
                    h = self._submit(b, between=lambda: done.append(p.finish()),
                                     staged=staged)
                prev = h
                while done:
                    yield done.pop(0)
            if prev is not None:
                last, prev = prev, None
                yield last.finish()
        except BaseException:
            self._release_held()
            raise

    def compress_all(self, buffers: Iterable) -> list:
        """Compress ``buffers``; returns the containers as a list of
        ``bytes``, each owning its storage (with ``pool_staging`` too)."""
        if not self._pool:
            return list(self.compress_iter(buffers))
        return [bytes(c) for c in self.compress_iter(buffers)]

    def compress(self, data):
        """Single-container convenience (no pipelining)."""
        self.timings = []
        return self._submit(data).finish()
