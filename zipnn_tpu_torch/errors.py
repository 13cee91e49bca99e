"""Structured codec exceptions (SURVEY.md §5 failure-detection mandate).

The reference surfaces corruption as bare ``PyErr_SetString`` messages
(csrc/zipnn_core.c passim); here every decode-side failure names the exact
(plane, chunk[, stream]) cell so a batch orchestrator can log, skip, or
re-fetch precisely the damaged shard.  ``CorruptChunkError`` subclasses
``ValueError`` so existing callers (and reference-style ``except
ValueError``) keep working.
"""
from __future__ import annotations

from typing import Optional


class CorruptChunkError(ValueError):
    """A (plane, chunk) cell failed to decode.

    Attributes mirror the container geometry: ``plane`` is the byte-group
    index, ``chunk`` the chunk index within the frame, ``stream`` the HUF
    sub-stream (0-3) when known, ``detail`` the low-level cause.
    """

    def __init__(
        self,
        detail: str,
        *,
        plane: Optional[int] = None,
        chunk: Optional[int] = None,
        stream: Optional[int] = None,
    ):
        self.plane = plane
        self.chunk = chunk
        self.stream = stream
        where = []
        if plane is not None:
            where.append(f"plane {plane}")
        if chunk is not None:
            where.append(f"chunk {chunk}")
        if stream is not None:
            where.append(f"stream {stream}")
        loc = f" ({', '.join(where)})" if where else ""
        super().__init__(f"corrupt chunk{loc}: {detail}")
