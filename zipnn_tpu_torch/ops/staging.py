"""Pinned, reused host staging for copies between host and card, and the
copy stream.

The counterpart of the JAX package's staging pool
(``ops/jax_codec.py`` ``_stage_pool_acquire`` / ``_stage_pool_release``).
A copy from or to pageable memory is one blocking transfer through the
CUDA runtime's own bounce buffer; a copy from or to page-locked memory
runs as an asynchronous DMA on a stream.  So :func:`upload` cuts its bytes
into pieces of at most ``PIECE_BYTES``: the host copies piece k+1 into a
pinned buffer while piece k goes up with ``non_blocking=True`` on the
pool's copy stream; and :func:`download`, the other direction, brings
piece k+1 down while the host copies piece k out to its final place.

:class:`Pool` holds the page-locked buffers (``torch.empty(...,
pin_memory=True)``, whose first allocation costs tens of milliseconds
per hundred MB) for reuse across pieces, calls and containers, up to
``POOL_BYTES`` in all, and one copy stream.  A buffer goes back to the
free list only after the CUDA event recorded behind the copy that read it
has completed, so no piece is refilled while its DMA still reads it.

Only CUDA devices stage: on ``device="cpu"`` the caller's arrays are the
"device" tensors already, and no pool exists.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import stats

PIECE_BYTES = 8 << 20  # bytes per pinned buffer and per DMA
POOL_BYTES = 128 << 20  # page-locked bytes a pool holds, free and busy together
DOWNLOAD_DEPTH = 3  # pieces a download keeps in flight while the host empties the oldest


class Pool:
    """Pinned buffers and the copy stream of one CUDA device."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"staging.Pool needs a CUDA device, got {self.device}")
        self.stream = torch.cuda.Stream(self.device)
        self.free: List[torch.Tensor] = []
        self.busy: List[Tuple[torch.Tensor, torch.cuda.Event]] = []
        self.held = 0  # bytes of every buffer the pool owns
        self.allocated = 0  # pinned allocations made, for the callers that report them
        self._lock = threading.Lock()

    def _reclaim(self) -> None:
        still = []
        for buf, event in self.busy:
            if event.query():
                self.free.append(buf)
            else:
                still.append((buf, event))
        self.busy = still

    def acquire(self, n: int) -> torch.Tensor:
        """A pinned uint8 buffer of ``PIECE_BYTES`` (``n`` bytes or more),
        waiting for the oldest copy in flight when the pool holds
        ``POOL_BYTES``."""
        if n > PIECE_BYTES:
            raise ValueError(f"staging piece of {n} bytes > PIECE_BYTES")
        with self._lock:
            while True:
                self._reclaim()
                if self.free:
                    return self.free.pop()
                if self.held + PIECE_BYTES <= POOL_BYTES or not self.busy:
                    break
                self.busy[0][1].synchronize()
            buf = torch.empty(PIECE_BYTES, dtype=torch.uint8, pin_memory=True)
            if not buf.is_pinned():
                raise RuntimeError("staging: pinned allocation returned pageable memory")
            self.held += buf.numel()
            self.allocated += 1
            return buf

    def release(self, buf: torch.Tensor, event: torch.cuda.Event) -> None:
        """Give ``buf`` back once ``event`` (recorded behind its copy) has
        completed."""
        with self._lock:
            self.busy.append((buf, event))


_pools: Dict[torch.device, Pool] = {}
_pools_lock = threading.Lock()


def pool(device) -> Pool:
    """The staging pool of a CUDA device (made at first use)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _pools_lock:
        if device not in _pools:
            _pools[device] = Pool(device)
        return _pools[device]


def as_tensor(a: np.ndarray) -> torch.Tensor:
    """A uint8 CPU tensor over a flat array's bytes (no copy; a read-only
    buffer, such as a container's ``bytes``, is only read)."""
    import warnings  # noqa: PLC0415

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def upload(p: Pool, src: torch.Tensor, dst: torch.Tensor,
           ranges: Sequence[Tuple[int, int]], timings: dict, *,
           label: str) -> torch.cuda.Event:
    """Copy ``src[off : off + n]`` to ``dst[off : off + n]`` for each
    ``(off, n)`` of ``ranges`` through pinned pieces on the pool's copy
    stream; returns an event recorded there behind the last piece.  Adds
    the host seconds of the copies into pinned memory to
    ``timings["stage_s"]``, each copy a ``<label>:stage`` span
    (``stats.phase``)."""
    stage_s = 0.0
    with torch.cuda.stream(p.stream):
        for off, n in ranges:
            for o in range(off, off + n, PIECE_BYTES):
                m = min(PIECE_BYTES, off + n - o)
                buf = p.acquire(m)
                with stats.phase(f"{label}:stage"):
                    t0 = time.perf_counter()
                    buf[:m].copy_(src[o : o + m])
                    stage_s += time.perf_counter() - t0
                dst[o : o + m].copy_(buf[:m], non_blocking=True)
                done = torch.cuda.Event()
                done.record(p.stream)
                p.release(buf, done)
        event = torch.cuda.Event(enable_timing=True)
        event.record(p.stream)
    timings["stage_s"] = timings.get("stage_s", 0.0) + stage_s
    return event


def download(p: Pool, src: torch.Tensor, dst, ranges: Sequence[Tuple[int, int, int]],
             timings: dict, after: Optional[torch.cuda.Event] = None, *,
             label: str) -> None:
    """Copy ``src[s : s + n]`` (a uint8 device tensor) to ``dst[d : d + n]``
    (host memory: a writable uint8 numpy array or CPU tensor) for each
    ``(s, d, n)`` of ``ranges``; returns once every byte is in ``dst``.

    The pool's copy stream first waits on ``after``, an event recorded
    behind the work that wrote ``src`` (recorded on the current stream now
    when None), and ``src`` is marked as in use there.  Page-locked ``dst``
    takes one DMA a range, straight in.  Else each range comes down in
    pinned pieces of at most ``PIECE_BYTES``, up to ``DOWNLOAD_DEPTH`` in
    flight: the host copies the oldest into ``dst`` while later ones' DMAs
    run, and a piece goes back to the pool once its host copy is done (or
    once its DMA is, when the download fails).  Adds the host seconds of
    the copies out of pinned memory to ``timings["unstage_s"]`` and the
    copy stream's span, first DMA to last, to ``timings["download_s"]``;
    the call is a ``<label>:download`` span (``stats.phase``), each host
    copy a ``<label>:unstage`` one."""
    with stats.phase(f"{label}:download"):
        dst = dst if isinstance(dst, torch.Tensor) else torch.from_numpy(dst)
        if after is None:
            after = torch.cuda.Event()
            after.record(torch.cuda.current_stream(src.device))
        src.record_stream(p.stream)
        first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        depth = max(1, min(DOWNLOAD_DEPTH, POOL_BYTES // PIECE_BYTES))
        pending: deque = deque()
        unstage_s = 0.0

        def empty_oldest() -> float:
            buf, d, m, done = pending.popleft()
            done.synchronize()
            with stats.phase(f"{label}:unstage"):
                t0 = time.perf_counter()
                dst[d : d + m].copy_(buf[:m])
                took = time.perf_counter() - t0
            p.release(buf, done)
            return took

        with torch.cuda.stream(p.stream):
            p.stream.wait_event(after)
            first.record(p.stream)
            if dst.is_pinned():
                for s, d, n in ranges:
                    dst[d : d + n].copy_(src[s : s + n], non_blocking=True)
                last.record(p.stream)
            else:
                try:
                    for s, d, n in ranges:
                        for o in range(0, n, PIECE_BYTES):
                            m = min(PIECE_BYTES, n - o)
                            buf = p.acquire(m)
                            buf[:m].copy_(src[s + o : s + o + m], non_blocking=True)
                            done = torch.cuda.Event()
                            done.record(p.stream)
                            pending.append((buf, d + o, m, done))
                            if len(pending) > depth:
                                unstage_s += empty_oldest()
                    last.record(p.stream)
                    while pending:
                        unstage_s += empty_oldest()
                finally:
                    for buf, _, _, done in pending:
                        p.release(buf, done)
        last.synchronize()
        timings["unstage_s"] = timings.get("unstage_s", 0.0) + unstage_s
        timings["download_s"] = (timings.get("download_s", 0.0)
                                 + first.elapsed_time(last) / 1e3)
