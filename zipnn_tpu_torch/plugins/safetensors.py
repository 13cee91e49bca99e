"""safetensors integration: per-tensor transparent decompression on the
card.

Compressed tensors are stored inside an ordinary safetensors file as uint8
tensors; the file-level metadata key ``znn_compressed_vectors`` maps tensor
name -> ``{"dtype": ..., "shape": ...}`` of the original tensor.  This is the
reference's on-disk schema (zipnn/util_safetensors.py:9-58), so files written
by the port, the JAX package or the reference load with any of them.

``SafeOpen`` stands in for ``safetensors.safe_open`` (reference
zipnn/zipnn.py:1592-1626), reading the file with the port's own parser.
It decodes every compressed tensor on its ``decode_device`` (the port's
own keyword: the card unless the caller passes ``decode_device="cpu"``)
and then hands the tensor to the ``device`` its caller asked for, so a
caller that opens a file with ``device="cpu"`` (as transformers does)
still decodes on the card.
``zipnn_safetensors()`` installs it as the ``safe_open`` of the torch and
numpy frontends, propagated into spawned worker processes so vLLM/sglang
engines pick it up.  The port holds no JAX arrays: the flax frontend is
left alone, and ``SafeOpen`` refuses it.
"""
from __future__ import annotations

import functools
import importlib
import json
from typing import Dict

import numpy as np
import torch

from ..io.streaming import METADATA_KEY, SafetensorsStreamReader
from ..zipnn import ZipNN
from .patch import multi_process_patcher

COMPRESSION_METHOD = "HUFFMAN"
COMPRESSED_DTYPE_NAME = "uint8"


# ---------------------------------------------------------------------------
# metadata schema
# ---------------------------------------------------------------------------

def build_compressed_tensor_info(uncompressed_tensor) -> Dict[str, str]:
    """Per-tensor metadata entry: original dtype + shape as strings."""
    dtype = str(uncompressed_tensor.dtype)
    if dtype.startswith("torch."):
        dtype = dtype[len("torch."):]
    return {"dtype": dtype, "shape": str(list(uncompressed_tensor.shape))}


def set_compressed_tensors_metadata(
    compressed_tensor_infos: Dict[str, Dict[str, str]], metadata: Dict[str, str]
) -> None:
    if metadata is not None:
        metadata[METADATA_KEY] = json.dumps(compressed_tensor_infos)


def get_compressed_tensors_metadata(metadata) -> Dict[str, Dict[str, str]]:
    if not metadata:
        return {}
    raw = metadata.get(METADATA_KEY)
    return json.loads(raw) if raw else {}


# ---------------------------------------------------------------------------
# tensor codecs
# ---------------------------------------------------------------------------

def compress_tensor(tensor, device="cuda"):
    """Compress one torch tensor on ``device`` -> (uint8 CPU tensor, info),
    or None when compression does not shrink it (the keep-raw-if-bigger
    rule of the reference CLI, scripts/zipnn_compress_safetensors.py:103-109)."""
    blob = ZipNN(input_format="torch", method=COMPRESSION_METHOD, device=device).compress(tensor)
    if len(blob) >= tensor.numel() * tensor.element_size():
        return None
    info = build_compressed_tensor_info(tensor)
    return torch.from_numpy(np.frombuffer(blob, dtype=np.uint8).copy()), info


def decompress_tensor(tensor, device="cuda"):
    """Decompress a stored uint8 tensor back to the original torch tensor,
    on ``device`` (reference zipnn.py:1584-1589)."""
    znn = ZipNN(input_format="torch", bytearray_dtype=COMPRESSED_DTYPE_NAME,
                method=COMPRESSION_METHOD, device=device)
    return znn.decompress(tensor.detach().cpu().contiguous().numpy())


def _framework(framework) -> str:
    """``"pt"`` or ``"np"``; the flax frontend is refused."""
    fw = (framework or "pt").lower()
    if fw in ("pt", "torch"):
        return "pt"
    if fw in ("np", "numpy"):
        return "np"
    if fw in ("flax", "jax"):
        raise ValueError(
            "the PyTorch port holds no JAX arrays: open the file with "
            "framework='pt' (or 'np'), or use the JAX package's plugin"
        )
    raise ValueError(f"Unsupported safetensors framework {framework!r}")


def _to_framework(t, framework: str, device="cpu"):
    """A decoded torch tensor in the frontend the file was opened with: on
    ``device`` for torch (left where it is for None), a host array for
    numpy (which has no bf16 or fp8)."""
    if _framework(framework) == "pt":
        return t if device is None else t.to(device)
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# safe_open wrapper
# ---------------------------------------------------------------------------

class SafeOpen:
    """Drop-in ``safetensors.safe_open`` with transparent decompression on
    ``decode_device``.

    The file is read by ``io.streaming.SafetensorsStreamReader``: ``keys``,
    ``metadata``, ``get_tensor`` and ``get_tensors`` need no
    ``safetensors`` package.  ``get_slice`` of an uncompressed tensor, and
    any other attribute of the package's ``safe_open`` object, open the
    file through the package when first asked for, and raise
    ``ImportError`` where it is not installed.
    """

    def __init__(self, filename, framework, device="cpu", decode_device="cuda"):
        self._filename = filename
        self._framework_arg = framework
        self._framework = _framework(framework)
        self._device = device
        self._reader = SafetensorsStreamReader(filename, decode_device)
        self._f = None  # the package's safe_open, opened on first need
        self.compressed_tensors_metadata = self._reader.compressed

    def _package(self, what: str):
        """The package's ``safe_open`` of the file (the stored bytes stay on
        the host), opened once."""
        if self._f is None:
            try:
                import safetensors  # noqa: PLC0415
            except ImportError as exc:
                raise ImportError(
                    f"SafeOpen.{what} needs the safetensors package, which is not "
                    "installed (keys, metadata, get_tensor and get_tensors do not)"
                ) from exc
            self._f = safetensors.safe_open(self._filename, self._framework_arg, device="cpu")
        return self._f

    def keys(self):
        """The tensor names, sorted (as ``safe_open.keys()``)."""
        return sorted(self._reader.keys())

    def metadata(self):
        """The file's ``__metadata__``, or None where it has none."""
        md = self._reader.raw_metadata
        return None if md is None else dict(md)

    def get_tensor(self, name):
        if name in self.compressed_tensors_metadata:
            return self.get_tensors([name])[name]
        return _to_framework(self._reader.stored(name), self._framework, self._device)

    def get_tensors(self, names=None):
        """Bulk load: ``{name: tensor}`` for ``names`` (default: all keys).

        Compressed tensors decode back to back on ``decode_device`` through
        ``io.serving.ShardDecoder.decompress_iter`` (tensor N+1's host plan
        and uploads while tensor N's kernels run); ``get_tensor`` of a
        compressed name takes this same route.
        """
        names = self.keys() if names is None else list(names)
        comp = [n for n in names if n in self.compressed_tensors_metadata]
        decoded = {n: _to_framework(t, self._framework, self._device)
                   for n, t in zip(comp, self._reader.decoded(comp))}
        return {n: decoded[n] if n in decoded else self.get_tensor(n) for n in names}

    def get_slice(self, name):
        if name not in self.compressed_tensors_metadata:
            return self._package("get_slice").get_slice(name)
        raise NotImplementedError(
            "get_slice on a znn-compressed tensor is not supported; use get_tensor"
        )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if self._f is not None:
            self._f.__exit__(exc_type, exc_value, traceback)
        return False

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._package(name), name)


def _patch_safe_open(decode_device: str) -> None:
    opener = functools.partial(SafeOpen, decode_device=decode_device)
    for modname in ("torch", "numpy"):
        try:
            mod = importlib.import_module(f"safetensors.{modname}")
        except ImportError:
            continue
        mod.safe_open = opener


@functools.lru_cache(maxsize=None)
def _patcher(decode_device: str):
    """One patch function per decode device, so installing it twice
    registers it once."""
    return functools.partial(_patch_safe_open, decode_device)


def zipnn_safetensors(decode_device="cuda") -> None:
    """Install transparent ``.safetensors`` tensor decompression on
    ``decode_device``, propagated to spawned processes (reference
    zipnn.py:1638-1643)."""
    multi_process_patcher(_patcher(str(decode_device)))
