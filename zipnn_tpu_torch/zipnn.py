"""The ``ZipNN`` user-facing codec class of the PyTorch/CUDA port.

The same constructor knobs, ``compress``/``decompress`` entry points and
``.znn`` containers as the JAX package's ``ZipNN`` (reference
zipnn/zipnn.py:27-1218), with ``engine="cuda"`` in place of ``"tpu"`` and
an explicit ``device``:

* ``engine="cuda"`` (default) decompresses through the CUDA kernels onto
  ``device`` (the card unless the caller passes ``device="cpu"``, where
  the kernels' plain versions run); ``engine="numpy"`` runs the golden
  model on the host.  Compress runs the golden encoder in both engines.
* ``input_format="torch"`` returns a tensor on ``device`` (on the host
  with ``engine="numpy"``); ``"byte"`` and ``"numpy"`` return host data.

Not in this slice of the port (ROADMAP queue 1): streaming frames, delta
and lossy modes, the zstd/lz4/snappy whole-buffer methods, the shared
Huffman-table profile and the fp32 CUDA decode.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import codec
from .core import dtypes
from .core.enums import EnumFormat, EnumLossy, EnumMethod
from .core.header import HEADER_LEN, Header

_FORMATS_WITH_SHAPE = (EnumFormat.TORCH.value, EnumFormat.NUMPY.value, EnumFormat.JAX.value)
# explicit byte_reorder codes of the whole-buffer path (reference compress_bin:697)
_VANILLA_BYTE_REORDERS = (0b1_01_01_001, 0b0_00_01_001)
_TORCH_VIEW = {
    1: torch.float32, 2: torch.float32, 4: torch.float16, 5: torch.float16,
    6: torch.bfloat16, 29: torch.float8_e4m3fn, 30: torch.float8_e5m2,
}


class ZipNN:
    def __init__(
        self,
        method: str = "AUTO",
        input_format: str = "byte",
        bytearray_dtype: str = "bfloat16",
        compression_threshold: float = 0.95,
        check_th_after_percent: int = 10,
        compression_chunk: int = 256 * 1024,
        engine: str = "cuda",
        device="cuda",
    ):
        """Configure a compressor/decompressor (knobs as the reference's)."""
        self.method = EnumMethod(method).value
        if self.method not in (EnumMethod.AUTO.value, EnumMethod.HUFFMAN.value):
            raise NotImplementedError(
                f"method {method!r} is not ported yet (ROADMAP queue 1)"
            )
        self.input_format = EnumFormat(input_format).value
        if self.input_format not in (
            EnumFormat.BYTE.value, EnumFormat.TORCH.value, EnumFormat.NUMPY.value
        ):
            raise ValueError(f"input_format must be byte, torch or numpy, got {input_format!r}")
        self.bytearray_dtype = bytearray_dtype
        self.compression_threshold = compression_threshold
        if int(check_th_after_percent or 0) < 0:
            raise ValueError("check_th_after_percent must be >= 0 (0 disables)")
        self.check_th_after_percent = int(check_th_after_percent or 0)
        if engine not in codec.ENGINES:
            raise ValueError(f"engine must be one of {codec.ENGINES}, got {engine!r}")
        self.engine = engine
        self.device = torch.device(device)
        if self.engine == "cuda" and self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "engine='cuda' with device='cuda' needs a CUDA device; "
                "pass device='cpu' to run the kernels' plain versions"
            )
        if (compression_chunk & (compression_chunk - 1)) != 0:
            raise ValueError("compression_chunk must be a number that is a power of 2.")
        self.compression_chunk = compression_chunk
        self._version = (0, 5, 3)
        self.dtype = 0
        self.original_len = 0
        self.shape_bytes: tuple = ()
        self.last_stats = None

    def _record_stats(self, op: str, original: int, compressed: int, seconds: float):
        from .stats import CodecStats  # noqa: PLC0415

        self.last_stats = CodecStats(
            op=op, original_bytes=original, compressed_bytes=compressed,
            seconds=seconds, engine=self.engine,
            dtype=str(self.bytearray_dtype), chunk_size=self.compression_chunk,
        )

    # ------------------------------------------------------------------
    # compression
    # ------------------------------------------------------------------
    def _resolve_dtype_and_bytes(self, data):
        """Returns (dtype_code, shape, flat uint8 host array)."""
        fmt = self.input_format
        if fmt == EnumFormat.BYTE.value:
            info = dtypes.from_any(self.bytearray_dtype)
            return info.code, None, np.frombuffer(memoryview(data), dtype=np.uint8)
        if fmt == EnumFormat.TORCH.value:
            info = dtypes.from_any(data.dtype)
            t = data.detach().contiguous().reshape(-1).cpu().view(torch.uint8)
            return info.code, tuple(data.shape), t.numpy()
        info = dtypes.from_any(data.dtype)
        arr = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        return info.code, data.shape, arr

    def compress(self, data):
        """Compress ``data`` (bytes / torch.Tensor / np.ndarray) into one
        ``.znn`` frame, byte-identical to the JAX package's numpy engine."""
        t0 = time.perf_counter()
        code, shape, arr = self._resolve_dtype_and_bytes(data)
        if not dtypes.from_code(code).is_float:
            raise ValueError("Support only torch.dtype float32/bfloat16/float16/fp8")
        grouping = dtypes.grouping_for_code(code)
        hdr = Header(
            method=self.method,
            input_format=self.input_format,
            compression_chunk=self.compression_chunk,
            version=self._version,
            byte_reorder=grouping.byte_reorder,
            bit_reorder=grouping.bit_reorder,
            dtype_code=code,
            original_len=arr.size,
        )
        if self.input_format in _FORMATS_WITH_SHAPE:
            hdr.shape = shape
        chunk = codec.effective_chunk(self.compression_chunk, grouping.num_buf)
        payload = codec.compress_payload(
            arr, grouping.num_buf, grouping.bit_reorder, grouping.byte_reorder,
            chunk, self.compression_threshold, self.engine,
            check_th_after_percent=self.check_th_after_percent,
        )
        prefix = HEADER_LEN + hdr.ext_len()
        hdr.total_len = prefix + len(payload)
        result = hdr.to_bytes() + payload
        self._record_stats("compress", arr.size, len(result), time.perf_counter() - t0)
        return result

    # ------------------------------------------------------------------
    # decompression
    # ------------------------------------------------------------------
    def _retrieve_header(self, ba_compress) -> int:
        hdr, consumed = Header.from_bytes(ba_compress, formats_with_shape=_FORMATS_WITH_SHAPE)
        if hdr.is_streaming or hdr.delta_mode or hdr.lossy_type != EnumLossy.NONE.value:
            raise NotImplementedError(
                "streaming, delta and lossy containers are not ported yet "
                "(ROADMAP queue 1)"
            )
        if hdr.byte_reorder in _VANILLA_BYTE_REORDERS:
            raise NotImplementedError(
                "whole-buffer (vanilla zstd/lz4/snappy) containers are not ported yet"
            )
        self._byte_reorder = hdr.byte_reorder
        self._bit_reorder = hdr.bit_reorder
        self.input_format = hdr.input_format
        self.compression_chunk = hdr.compression_chunk
        self.dtype = hdr.dtype_code
        self.original_len = hdr.original_len
        if hdr.shape is not None:
            self.shape_bytes = hdr.shape
        return consumed

    def decompress(self, data):
        """Decompress one ``.znn`` frame; inverse of :meth:`compress`."""
        t0 = time.perf_counter()
        mv = memoryview(data)
        after_header = self._retrieve_header(mv)
        total = int.from_bytes(mv[24:32], "little")
        end = total if 0 < total <= len(mv) else len(mv)
        num_buf = dtypes.groups_for_decompress(self.dtype)
        chunk = codec.effective_chunk(self.compression_chunk, num_buf)
        flat = codec.decompress_payload(
            mv[after_header:end], num_buf, self._bit_reorder, self._byte_reorder,
            chunk, self.original_len, self.engine, device=self.device,
        )
        result = self._marshal_out(flat)
        self._record_stats("decompress", self.original_len, len(mv), time.perf_counter() - t0)
        return result

    def _marshal_out(self, flat):
        """``flat`` is a host uint8 array (numpy engine) or a uint8 tensor
        (cuda engine) of the decompressed bytes."""
        fmt = self.input_format
        if fmt == EnumFormat.TORCH.value:
            code = self.dtype
            if code not in _TORCH_VIEW:
                raise ValueError(f"Unsupported Dtype {code}")
            t = torch.from_numpy(flat) if isinstance(flat, np.ndarray) else flat
            return t.view(_TORCH_VIEW[code]).reshape(self.shape_bytes)
        host = flat if isinstance(flat, np.ndarray) else flat.cpu().numpy()
        if fmt == EnumFormat.BYTE.value:
            return memoryview(host)
        if fmt == EnumFormat.NUMPY.value:
            info = dtypes.from_code(self.dtype)
            return host.view(dtypes.numpy_dtype(info)).reshape(self.shape_bytes).copy()
        raise ValueError(f"Unsupported input_format {fmt}")
