"""A configuration's checkpoint: its tensors, its units and its weights.

A configuration file (``configs/<name>.json``) lists the checkpoint's
tensors under ``checkpoint``: ``head`` and ``tail`` (the tensors outside
the blocks) and ``layers``, groups of blocks that share one template
(``{i}`` the layer; an entry ``{"each": "e", "count": n, "tensors": [...]}``
repeats its tensors for ``{e}`` = 0 .. n - 1).  The checkpoint holds the
tensors in that order: head, the blocks, tail.  A resident decode runs
them as units: each block, then head and tail together.

The weights are drawn on the card from the run's seed, N(0, ``std``) in
the container's dtype, in a few large calls into one flat buffer; each
tensor is a view of its slice.  The same seed gives the same bytes, so
the checks draw them again after the window.

The file's ``container`` block is the one statement of the profile the
checkpoint is stored in (``dtype``, ``chunk``, ``huffman_table``): the
program encodes in it and the reference encoder is held to it.  The
reference writes per-chunk tables only, so no other table is accepted.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}
STD = 0.05
DRAW = 1 << 28  # elements drawn per call
TABLES = ("per_chunk",)  # the Huffman tables the reference encoder writes


@dataclass
class Tensor:
    name: str
    shape: Tuple[int, ...]
    offset: int  # first element in the flat buffer

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclass
class Model:
    name: str
    dtype: str
    chunk: int  # bytes of original data a chunk
    huffman_table: str
    tensors: List[Tensor]
    units: List[List[int]]  # tensor indices a unit, in decode order

    @property
    def itemsize(self) -> int:
        return torch.empty(0, dtype=DTYPES[self.dtype]).element_size()

    @property
    def numel(self) -> int:
        return sum(t.numel for t in self.tensors)

    @property
    def nbytes(self) -> int:
        return self.numel * self.itemsize

    def tensor_bytes(self, i: int) -> int:
        return self.tensors[i].numel * self.itemsize


def _expand(entries, subst) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    for e in entries:
        if isinstance(e, dict):
            for k in range(e["count"]):
                out += _expand(e["tensors"], {**subst, e["each"]: k})
        else:
            out.append((e[0].format(**subst), tuple(e[1])))
    return out


def load(path: Path) -> Model:
    cfg = json.loads(Path(path).read_text())
    box = cfg["container"]
    if box["huffman_table"] not in TABLES:
        raise ValueError(f"{path}: the reference encoder writes {TABLES} tables only, "
                         f"not {box['huffman_table']!r}")
    ck = cfg["checkpoint"]
    head = _expand(ck.get("head", []), {})
    blocks = []
    for group in ck["layers"]:
        for i in range(group["first"], group["first"] + group["count"]):
            blocks.append(_expand(group["tensors"], {"i": i}))
    tail = _expand(ck.get("tail", []), {})
    tensors, units, off = [], [], 0

    def add(entries) -> List[int]:
        nonlocal off
        idx = []
        for name, shape in entries:
            t = Tensor(name, shape, off)
            off += t.numel
            idx.append(len(tensors))
            tensors.append(t)
        return idx

    rest = add(head)
    units = [add(b) for b in blocks]
    rest += add(tail)
    if rest:
        units.append(rest)
    return Model(Path(path).stem, box["dtype"], box["chunk"], box["huffman_table"], tensors, units)


def weights(model: Model, seed: int, device) -> torch.Tensor:
    """The checkpoint's flat buffer, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(model.numel, dtype=DTYPES[model.dtype], device=device)
    for lo in range(0, model.numel, DRAW):
        flat[lo : lo + DRAW].normal_(0.0, STD, generator=gen)
    return flat


def views(model: Model, flat: torch.Tensor, idx: Sequence[int] = None) -> List[torch.Tensor]:
    """Tensors of ``model`` as views of ``flat`` (all, or those of ``idx``)."""
    idx = range(len(model.tensors)) if idx is None else idx
    out = []
    for i in idx:
        t = model.tensors[i]
        out.append(flat[t.offset : t.offset + t.numel].view(t.shape))
    return out
