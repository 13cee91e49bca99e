"""I/O of the PyTorch/CUDA port: back-to-back container decode
(``serving.ShardDecoder``) and encode (``serving.ShardEncoder``), the
range-reading safetensors loader (``streaming.SafetensorsStreamReader``)
and tree checkpoints (``pytree.save_pytree`` / ``load_pytree``)."""

from .pytree import leaf_paths, load_pytree, save_pytree  # noqa: F401
from .serving import ShardDecoder, ShardEncoder, decompress_iter  # noqa: F401
from .streaming import SafetensorsStreamReader, partition_names  # noqa: F401

__all__ = ["ShardDecoder", "ShardEncoder", "decompress_iter", "SafetensorsStreamReader",
           "partition_names", "save_pytree", "load_pytree", "leaf_paths"]
