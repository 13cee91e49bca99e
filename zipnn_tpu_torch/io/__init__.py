"""Serving-side I/O of the PyTorch/CUDA port: back-to-back container
decode (``serving.ShardDecoder``) and encode (``serving.ShardEncoder``)."""

from .serving import ShardDecoder, ShardEncoder, decompress_iter  # noqa: F401

__all__ = ["ShardDecoder", "ShardEncoder", "decompress_iter"]
