"""Serving-side I/O of the PyTorch/CUDA port: back-to-back container
decode (``serving.ShardDecoder``)."""

from .serving import ShardDecoder, decompress_iter  # noqa: F401

__all__ = ["ShardDecoder", "decompress_iter"]
