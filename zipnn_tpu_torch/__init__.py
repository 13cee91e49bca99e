"""zipnn_tpu_torch — the PyTorch/CUDA port of zipnn_tpu.

Lossless compression for AI model weights in the ``.znn`` container:
byte-plane grouping with sign-bit rotation and per-chunk Huffman coding.
The port decompresses reference-profile containers straight into GPU
memory through hand-written CUDA kernels (``ops/huf_pc.py``,
``ops/combine.py``, sources in ``csrc/``), and carries its own copy of the
format's host code, so it imports neither JAX nor the JAX package.
"""

from .errors import CorruptChunkError  # noqa: F401
from .zipnn import ZipNN  # noqa: F401

__version__ = "0.1.0"

__all__ = ["ZipNN", "CorruptChunkError", "__version__"]
