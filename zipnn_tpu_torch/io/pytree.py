"""Compressed checkpoints of nested dicts, lists and tuples of torch
tensors on the safetensors container.

The port of the JAX package's ``io/pytree.py``:

* :func:`save_pytree` flattens a tree with key paths and writes ONE
  ``.znn.safetensors`` file -- float leaves compressed per tensor under
  the reference ``znn_compressed_vectors`` schema (util_safetensors.py:
  9-58), so the file also loads through the JAX package, ``SafeOpen`` and
  ``zipnn_safetensors()``;
* :func:`load_pytree` reads it with ``io.streaming.SafetensorsStreamReader``
  (compressed leaves decoded back to back on ``decode_device`` by
  ``io.serving.ShardDecoder``) and puts each leaf on the device the
  caller chose for it.

Key paths are joined with ``/`` exactly as the JAX package's ``leaf_paths``
joins them (dict keys in sorted order, sequence indices, namedtuple field
names), so a file either package writes loads in the other.  Without a
``like`` tree, :func:`load_pytree` returns nested dicts keyed by path
components; with one, its structure is rebuilt.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .streaming import SafetensorsStreamReader

__all__ = ["save_pytree", "load_pytree", "leaf_paths"]


def _children(node):
    """(key, child) pairs of a container node, or None for a leaf; None
    itself is an empty subtree."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return [] if node is None else None


def _walk(node, comps, out: Dict[str, Any]) -> None:
    kids = _children(node)
    if kids is None:
        name = "/".join(comps) or "_root"
        if name in out:
            raise ValueError(f"duplicate leaf path {name!r}")
        out[name] = node
        return
    for key, child in kids:
        if "/" in key:
            raise ValueError(
                f"pytree key {key!r} contains the path separator '/'; "
                "rename the key (paths could not round-trip without "
                "the original structure)"
            )
        _walk(child, comps + [key], out)


def leaf_paths(tree) -> Dict[str, Any]:
    """Flatten a tree of dicts, lists and tuples to ``{'a/b/0': leaf}``.

    ``/`` is the path separator, so a dict key that itself contains ``/``
    is refused.  Sequence leaves come back from :func:`load_pytree` as dicts
    keyed by stringified indices unless ``like`` gives the structure.
    """
    out: Dict[str, Any] = {}
    _walk(tree, [], out)
    return out


def save_pytree(
    path: str,
    tree,
    *,
    engine: str = "cuda",
    huffman_table: str = "per_chunk",
    device="cuda",
) -> Dict[str, bool]:
    """Write ``tree`` (torch tensor leaves) as one compressed
    ``.znn.safetensors`` file, compressing on ``device`` with ``engine``.

    Float leaves are compressed per tensor (keep-raw-if-bigger rule,
    reference scripts/zipnn_compress_safetensors.py:103-109); integer and
    bool leaves store raw.  Returns {path: was_compressed}.
    """
    from safetensors.torch import save_file  # noqa: PLC0415

    from ..plugins.safetensors import (  # noqa: PLC0415
        COMPRESSION_METHOD, build_compressed_tensor_info,
        set_compressed_tensors_metadata,
    )
    from ..zipnn import ZipNN  # noqa: PLC0415

    znn = ZipNN(input_format="torch", method=COMPRESSION_METHOD, engine=engine,
                huffman_table=huffman_table, device=device)
    out: Dict[str, torch.Tensor] = {}
    infos: Dict[str, Dict[str, str]] = {}
    compressed: Dict[str, bool] = {}
    for name, t in leaf_paths(tree).items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"leaf {name!r} is a {type(t).__name__}, not a torch.Tensor")
        blob = None
        if t.is_floating_point():
            b = znn.compress(t)
            if len(b) < t.numel() * t.element_size():
                blob = b
        compressed[name] = blob is not None
        if blob is None:
            out[name] = t.detach().cpu().contiguous()
        else:
            infos[name] = build_compressed_tensor_info(t)
            out[name] = torch.from_numpy(np.frombuffer(blob, dtype=np.uint8).copy())
    metadata: Dict[str, str] = {"format": "pt"}
    set_compressed_tensors_metadata(infos, metadata)
    save_file(out, path, metadata=metadata)
    return compressed


def _rebuild(node, comps, values: Dict[str, Any]):
    """``node``'s structure with each leaf replaced by its loaded value."""
    kids = _children(node)
    if kids is None:
        name = "/".join(comps) or "_root"
        if name not in values:
            raise KeyError(f"checkpoint is missing leaf {name!r}")
        return values.pop(name)
    if node is None:
        return None
    got = {key: _rebuild(child, comps + [key], values) for key, child in kids}
    if isinstance(node, dict):
        return {k: got[str(k)] for k in node}
    if hasattr(node, "_fields"):
        return type(node)(*got.values())
    return type(node)(got.values())


def load_pytree(path: str, *, like=None, devices=None, decode_device="cuda"):
    """Load a :func:`save_pytree` file (or the JAX package's) back into a
    tree of torch tensors.

    Compressed leaves decode on ``decode_device`` (the card unless the
    caller passes ``decode_device="cpu"``).  ``devices`` places each leaf:
    None (every leaf on ``decode_device``), one ``torch.device`` for every
    leaf, a ``{path: device}`` dict (missing paths on ``decode_device``), or
    a callable ``path -> device | None``.

    ``like``: a tree of the same structure; when given, the result has its
    structure.  Without it the result is nested dicts keyed by path parts.
    """
    with SafetensorsStreamReader(path, decode_device) as r:
        values = r.load_shard(device=decode_device)

    def _device_for(name: str):
        if devices is None:
            return None
        if callable(devices):
            return devices(name)
        if isinstance(devices, dict):
            return devices.get(name)
        return devices

    for name, v in values.items():
        dev = _device_for(name)
        if dev is not None:
            values[name] = v.to(dev)

    if like is not None:
        out = _rebuild(like, [], values)
        if values:
            raise ValueError(f"checkpoint has extra leaves {sorted(values)[:5]}")
        return out

    root: Dict[str, Any] = {}
    for name, v in values.items():
        parts = name.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root.get("_root", root) if list(root) == ["_root"] else root
