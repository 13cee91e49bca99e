"""zipnn_tpu_torch — the PyTorch/CUDA port of zipnn_tpu.

Lossless compression for AI model weights in the ``.znn`` container:
byte-plane grouping with sign-bit rotation and per-chunk Huffman coding.
The port decompresses containers of both Huffman profiles (per-chunk and
shared-table) straight into GPU memory through hand-written CUDA kernels
(``ops/huf_pc.py``, ``ops/huf_shared.py``, ``ops/combine.py``, sources in
``csrc/``), writes both profiles on the card, and carries its own copy
of the format's host code (Python, and the native C++ core that engine
``"native"`` and the card's host steps run, ``native.py``), so it imports
neither JAX nor the JAX package.  Loaders decode on the card too:
``io.streaming`` (safetensors range reads), ``io.pytree`` and
``plugins`` (``SafeOpen``, ``zipnn_safetensors``, ``zipnn_hf``).
"""

from .errors import CorruptChunkError  # noqa: F401
from .zipnn import ZipNN  # noqa: F401

__version__ = "0.1.0"


def zipnn_hf(replace_local_file: bool = False, decode_device="cuda"):
    """Patch transformers to load ``.znn`` checkpoints, decoded on
    ``decode_device``."""
    from .plugins.hf import zipnn_hf as _impl  # noqa: PLC0415

    return _impl(replace_local_file=replace_local_file, decode_device=decode_device)


def zipnn_safetensors(decode_device="cuda"):
    """Patch ``safetensors.safe_open`` to decompress tensors on
    ``decode_device``."""
    from .plugins.safetensors import zipnn_safetensors as _impl  # noqa: PLC0415

    return _impl(decode_device=decode_device)


__all__ = ["ZipNN", "CorruptChunkError", "zipnn_hf", "zipnn_safetensors", "__version__"]
