"""Hugging Face transformers integration for ``.znn`` checkpoints.

Behavioral equivalent of the reference plugin (zipnn/zipnn.py:1221-1577),
decoding on the card:

* ``modeling_utils.load_state_dict`` learns to open ``*.znn`` files —
  streaming-decompress into memory (the frames decoded together on
  ``decode_device``, the card unless the caller passes
  ``decode_device="cpu"``: ``ops.decode.frame_runs``), then hand the bytes to
  ``safetensors.torch.load`` (for ``.safetensors.znn``) or ``torch.load``;
  with ``replace_local_file=True`` the decompressed file replaces the
  hub-cache blob (symlink surgery + index-json suffix rewrite).
* ``PreTrainedModel.from_pretrained`` probes the hub cache for each
  candidate weight name with a ``.znn`` suffix appended.
* ``modeling_utils.cached_file`` transparently appends ``.znn`` for names
  the probe phase found.

Signatures are version-tolerant (``*args/**kwargs`` passthrough) instead of
pinning one transformers release.
"""
from __future__ import annotations

import json
import os
from io import BytesIO
from struct import unpack

from ..zipnn import ZipNN

_SAFETENSORS_FORMATS = ("pt", "tf", "flax", "mlx")


def replace_in_file(file_path, old: str, new: str) -> None:
    """Replace all occurrences of ``old`` with ``new`` in a text file."""
    with open(file_path, "r") as f:
        data = f.read()
    with open(file_path, "w") as f:
        f.write(data.replace(old, new))


def _decompress_file_to_bytes(path: str, decode_device="cuda") -> bytes:
    znn = ZipNN(is_streaming=True, device=decode_device)
    with open(path, "rb") as f:
        return bytes(znn.decompress(f.read()))


def _replace_cached_blob(compressed_path: str, output_file: str, d_data: bytes) -> None:
    """Write the decompressed payload over the hub-cache blob and fix links.

    Hub cache layout: ``snapshots/<rev>/<name>`` is a symlink into
    ``blobs/``.  We write the plain file, move it over the blob, re-point the
    snapshot symlink, and drop the ``.znn`` entry (reference zipnn.py:1286-1315).
    """
    snapshot_path = os.path.dirname(compressed_path)
    if not os.path.exists(output_file):
        with open(output_file, "wb") as f:
            f.write(d_data)
        if os.path.islink(compressed_path):
            blob = os.path.join(snapshot_path, os.readlink(compressed_path))
            os.rename(output_file, blob)
            os.symlink(blob, output_file)
    os.remove(compressed_path)
    base = os.path.basename(output_file)
    for index_name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        idx = os.path.join(snapshot_path, index_name)
        if os.path.exists(idx):
            target = os.path.join(snapshot_path, os.readlink(idx)) if os.path.islink(idx) else idx
            replace_in_file(target, f"{base}.znn", base)


def zipnn_hf(replace_local_file: bool = False, decode_device="cuda") -> None:
    """Patch transformers so ``from_pretrained`` loads ``.znn`` checkpoints,
    decoded on ``decode_device``."""
    try:
        import transformers  # noqa: PLC0415
        from transformers import modeling_utils  # noqa: PLC0415
        from transformers.modeling_utils import PreTrainedModel, _add_variant  # noqa: PLC0415
        from transformers.utils import (  # noqa: PLC0415
            FLAX_WEIGHTS_NAME,
            SAFE_WEIGHTS_INDEX_NAME,
            SAFE_WEIGHTS_NAME,
            TF2_WEIGHTS_NAME,
            TF_WEIGHTS_NAME,
            WEIGHTS_INDEX_NAME,
            WEIGHTS_NAME,
            cached_file,
        )
    except ImportError as exc:
        raise ImportError(
            "Hugging Face Transformers library is not installed. "
            "Please install it to use ZipNN compression."
        ) from exc

    import torch  # noqa: PLC0415
    from safetensors.torch import load as st_load  # noqa: PLC0415

    original_load_state_dict = modeling_utils.load_state_dict

    def _load_znn(checkpoint_file: str):
        """Returns a state dict for a ``.znn`` checkpoint, else None."""
        if not str(checkpoint_file).endswith(".znn"):
            return None
        print(f"Decompressing {os.path.basename(checkpoint_file)}")
        output_file = checkpoint_file[: -len(".znn")]

        if os.path.exists(output_file):
            with open(output_file, "rb") as f:
                d_data = f.read()
        else:
            d_data = _decompress_file_to_bytes(checkpoint_file, decode_device)
            if replace_local_file:
                _replace_cached_blob(checkpoint_file, output_file, d_data)

        if checkpoint_file.endswith(".safetensors.znn"):
            header_len = unpack("<Q", d_data[:8])[0]
            header = json.loads(d_data[8 : 8 + header_len])
            meta = header.get("__metadata__", {})
            if meta.get("format") not in _SAFETENSORS_FORMATS:
                raise OSError(
                    f"The safetensors archive passed at {checkpoint_file} does not "
                    "contain valid metadata. Make sure you save your model with the "
                    "`save_pretrained` method."
                )
            return st_load(d_data)
        return torch.load(BytesIO(d_data), map_location="cpu", weights_only=True)

    def custom_load_state_dict(checkpoint_file, *args, **kwargs):
        result = _load_znn(str(checkpoint_file))
        if result is not None:
            return result
        cf = str(checkpoint_file)
        if not os.path.exists(cf) and os.path.exists(cf.replace(".znn", "")):
            checkpoint_file = cf.replace(".znn", "")
        return original_load_state_dict(checkpoint_file, *args, **kwargs)

    modeling_utils.load_state_dict = custom_load_state_dict

    original_from_pretrained = PreTrainedModel.from_pretrained
    found_paths: list = []

    def custom_from_pretrained(cls, pretrained_model_name_or_path, *model_args, **kwargs):
        variant = kwargs.get("variant", None)
        cached_file_kwargs = {
            "cache_dir": kwargs.get("cache_dir"),
            "force_download": kwargs.get("force_download", False),
            "proxies": kwargs.get("proxies"),
            "resume_download": kwargs.get("resume_download"),
            "local_files_only": kwargs.get("local_files_only", False),
            "token": kwargs.get("token"),
            "revision": kwargs.get("revision", "main"),
            "subfolder": kwargs.get("subfolder", ""),
            "_raise_exceptions_for_gated_repo": False,
            "_raise_exceptions_for_missing_entries": False,
            "_commit_hash": kwargs.get("_commit_hash"),
        }
        # candidate weight names, reference zipnn.py:1446-1459
        candidates = [
            TF_WEIGHTS_NAME + ".index",
            TF2_WEIGHTS_NAME,
            FLAX_WEIGHTS_NAME,
            _add_variant(SAFE_WEIGHTS_NAME, variant),
            _add_variant(SAFE_WEIGHTS_INDEX_NAME, variant),
            _add_variant(WEIGHTS_NAME, variant),
            _add_variant(WEIGHTS_INDEX_NAME, variant),
            str(pretrained_model_name_or_path),
            str(pretrained_model_name_or_path) + ".index",
        ]
        for name in candidates:
            try:
                resolved = cached_file(
                    pretrained_model_name_or_path, name + ".znn", **cached_file_kwargs
                )
            except Exception:
                resolved = None
            if resolved is None:
                continue
            if not replace_local_file:
                if name not in found_paths:
                    found_paths.append(name)
            else:
                d_data = _decompress_file_to_bytes(resolved, decode_device)
                _replace_cached_blob(resolved, resolved[: -len(".znn")], d_data)
        return original_from_pretrained.__func__(
            cls, pretrained_model_name_or_path, *model_args, **kwargs
        )

    PreTrainedModel.from_pretrained = classmethod(custom_from_pretrained)

    original_cached_file = modeling_utils.cached_file

    def custom_cached_file(path_or_repo_id, filename, *args, **kwargs):
        if filename in found_paths:
            filename = filename + ".znn"
        return original_cached_file(path_or_repo_id, filename, *args, **kwargs)

    modeling_utils.cached_file = custom_cached_file
