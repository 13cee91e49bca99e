"""Per-call codec statistics: ``ZipNN.last_stats`` holds a
:class:`CodecStats` for the last compress or decompress."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class CodecStats:
    """One codec operation's worth of numbers."""

    op: str = ""  # "compress" | "decompress"
    original_bytes: int = 0
    compressed_bytes: int = 0
    seconds: float = 0.0
    engine: str = ""
    dtype: str = ""
    chunk_size: int = 0

    @property
    def ratio(self) -> float:
        return self.compressed_bytes / self.original_bytes if self.original_bytes else 0.0

    @property
    def saved_percent(self) -> float:
        return 100.0 * (1.0 - self.ratio)

    @property
    def throughput_GBps(self) -> float:
        return self.original_bytes / self.seconds / 1e9 if self.seconds > 0 else 0.0

    def as_dict(self) -> Dict:
        return {
            "op": self.op,
            "original_bytes": self.original_bytes,
            "compressed_bytes": self.compressed_bytes,
            "ratio": round(self.ratio, 6),
            "saved_percent": round(self.saved_percent, 3),
            "seconds": round(self.seconds, 6),
            "throughput_GBps": round(self.throughput_GBps, 4),
            "engine": self.engine,
            "dtype": self.dtype,
            "chunk_size": self.chunk_size,
        }
