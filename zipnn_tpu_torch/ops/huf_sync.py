"""The warp schedule of the Huffman decode kernels K1 and K6, modelled on
tensors.

``csrc/huf_decode.cuh`` decodes one backward bitstream per warp.  A
Huffman bitstream synchronises itself: a decoder started at an arbitrary
bit usually falls onto the true codeword boundaries within a few dozen
symbols (the exact parallel decode of Weissenberger & Schmidt, "Massively
Parallel Huffman Decoding on GPUs", ICPP 2018).  The stream's bit range
``(0, bits0]`` is cut into ``L = clamp(bits0 // MIN_SEG_BITS, 1, LANES)``
sub-segments of ``seg = ceil(bits0 / L)`` bits, from the top in decode
order; lane ``i`` owns ``(lo_i, bits0 - i * seg]`` with ``lo_i = max(bits0
- (i + 1) * seg, 0)`` (0 for the last lane).

* **A, speculative count.**  Lane ``i`` starts at the top of its
  sub-segment (lane 0 at ``bits0``, a true codeword start), steps while its
  cursor is above ``lo_i`` and keeps its step count ``c_i`` and exit
  position ``x_i``.
* **B, synchronisation.**  While some lane ``i > 0`` has a start other than
  ``x_{i-1}``, each such lane restarts there.  It walks its new path and
  its old one together, always advancing the higher cursor: where the two
  meet, the rest of the old path (its steps and exit) holds, so a re-decode
  costs about twice the distance to the meeting point.  Each pass fixes at
  least the first unsynchronised lane, so at most ``L`` passes run.
* **C, write.**  An exclusive prefix sum of ``c`` gives each lane its first
  output index; each lane re-decodes its range and writes the symbols below
  ``n``.  If ``sum(c) < n`` (a corrupt stream ran past bit 0), the serial
  chain would go on reading entry 0 of the table: the remaining symbols
  are its symbol and ``bits_left`` falls by its ``nb`` each.

A launch of short streams (``huf_pc.streams_per_warp``: fewer than
``huf_pc.GROUP_SYMBOLS`` symbols a stream on average for K1,
``huf_shared.GROUP_SYMBOLS`` for K6, as small chunks give) runs none of
this: each lane decodes a stream of its
own by the serial chain, since a short stream's few sub-segments would
leave most of a warp idle.

A lane that reaches ``seg`` steps (``2 * seg`` in a merge walk) while still
above its lower edge has met an entry with ``nb == 0``; its stream is then
decoded by the serial chain (here the lockstep plain version) — the same
function, computed serially.  The step rule is the serial chain's: peek the
``tlog`` bits below the cursor, zeros below bit 0, retreat by ``nb``.

The kernels read two symbols per table lookup where a canonical table
allows it (pair entries); that changes no step's position or symbol, so
the model steps one symbol at a time.  ``LANES`` and ``MIN_SEG_BITS`` are
``huf_pc``'s, which passes them to the kernels as arguments.
:func:`decode_segmented` is a model for the tests; nothing on the decode
path calls it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import huf_pc, huf_shared
from .huf_pc import LANES, MIN_SEG_BITS


def lane_geometry(bits0: torch.Tensor):
    """(L [S], seg [S]) as int64: lanes in use and sub-segment bits."""
    b0 = bits0.to(torch.int64)
    L = (b0 // MIN_SEG_BITS).clamp(1, LANES)
    seg = ((b0 + L - 1) // L).clamp(min=0)
    return L, seg


def decode_segmented(
    payload, starts, lens, bits0, out_offs, out_lens, n_out: int, *,
    cells=None, tlogs=None, tables=None, table=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode S streams by the warp schedule; the arguments of
    ``huf_pc.huf_pc_decode`` (per-cell ``cells``, ``tlogs``, ``tables``) or
    of ``huf_shared.huf_shared_decode`` (the 256-entry ``table``).

    Returns (out uint8 [n_out], bits_left int32 [S], passes int32 [S]):
    ``passes`` counts the synchronisation passes in which some lane of the
    stream re-decoded, -1 where the stream took the serial chain after a
    capped loop.  A launch of short streams
    (``huf_pc.streams_per_warp``, at the kernel's ``GROUP_SYMBOLS``) decodes each stream by
    one lane's serial chain: no passes.
    """
    dev = payload.device
    i64 = torch.int64
    S = int(starts.numel())
    if table is not None:
        cells = torch.zeros(S, dtype=torch.int32, device=dev)
        tlogs = torch.full((1,), 8, dtype=torch.int32, device=dev)
        tables = table.reshape(1, 256)
    out = torch.zeros(n_out, dtype=torch.uint8, device=dev)
    if S == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return out, z, z
    group = huf_pc.GROUP_SYMBOLS if table is None else huf_shared.GROUP_SYMBOLS
    if huf_pc.streams_per_warp(n_out, S, group) > 1:
        out, bl = huf_pc.huf_pc_decode_plain(
            payload, starts, lens, bits0, out_offs, out_lens, cells, tlogs,
            tables, n_out)
        return out, bl, torch.zeros(S, dtype=torch.int32, device=dev)
    one, _ = huf_pc._step_tables(payload, starts, lens, cells, tlogs, tables)
    Q = one.shape[1]
    one = one.reshape(-1)
    nb_t = (tables >> 8).to(i64).reshape(-1)
    sym_t = (tables & 0xFF).to(torch.uint8).reshape(-1)
    rowq = (torch.arange(S, device=dev, dtype=i64) * Q)[:, None]

    def entry(q):  # flat table index of the step at q (q > 0 here)
        return torch.take(one, rowq + q.clamp(0, Q - 1))

    n = out_lens.to(i64)[:, None]
    b0 = bits0.to(i64)[:, None]
    L, seg = (t[:, None] for t in lane_geometry(bits0))
    lane = torch.arange(LANES, device=dev, dtype=i64)[None, :]
    valid = lane < L
    start = torch.where(lane == 0, b0, b0 - lane * seg)
    lo = torch.where(lane + 1 < L, (b0 - (lane + 1) * seg).clamp(min=0), 0)

    # A: speculative count
    q = start.clone()
    c = torch.zeros_like(q)
    while True:
        act = valid & (q > lo) & (c < seg)
        if not bool(act.any()):
            break
        q = q - torch.where(act, nb_t[entry(q)], 0)
        c = c + act
    stuck = (valid & (q > lo)).any(1)
    x = q

    # B: synchronisation by merge walks
    passes = torch.zeros(S, dtype=i64, device=dev)
    for _ in range(LANES):
        xprev = torch.cat([start[:, :1], x[:, :-1]], dim=1)
        need = valid & (lane > 0) & (start != xprev) & ~stuck[:, None]
        if not bool(need.any()):
            break
        passes += need.any(1)
        a, b = start.clone(), xprev.clone()
        na = torch.zeros_like(a)
        nn = torch.zeros_like(a)
        while True:
            act = need & (a != b) & (torch.maximum(a, b) > lo) & (na + nn < 2 * seg)
            if not bool(act.any()):
                break
            adv_a = act & (a > b)
            adv_b = act & (b > a)
            e = entry(torch.maximum(a, b))
            a = a - torch.where(adv_a, nb_t[e], 0)
            b = b - torch.where(adv_b, nb_t[e], 0)
            na = na + adv_a
            nn = nn + adv_b
        stuck |= (need & (a != b) & (torch.maximum(a, b) > lo)).any(1)
        met = a == b
        c = torch.where(need, torch.where(met, nn + c - na, nn), c)
        x = torch.where(need, torch.where(met, x, b), x)
        start = torch.where(need, xprev, start)

    # C: write at prefix-sum offsets
    c = torch.where(valid, c, 0)
    o = torch.cumsum(c, dim=1) - c
    total = c.sum(1, keepdim=True)
    w = (n - o).clamp(min=0).minimum(c)
    off = out_offs.to(i64)[:, None] + o
    q = start.clone()
    for k in range(int(w.max()) if w.numel() else 0):
        act = k < w
        e = entry(q)
        pos = (off + k)[act]
        out[pos] = sym_t[e[act]]
        q = q - torch.where(act, nb_t[e], 0)
    holder = (o < n) & (n <= o + c)
    bl = torch.where(holder, q, 0).sum(1)
    x_last = torch.gather(x, 1, L - 1)[:, 0]
    e0 = torch.take(one, rowq[:, 0])
    short = (total[:, 0] < n[:, 0])
    bl = torch.where(short, x_last - (n[:, 0] - total[:, 0]) * nb_t[e0], bl)
    bl = torch.where(n[:, 0] == 0, b0[:, 0], bl)
    for s in torch.nonzero(short & ~stuck).reshape(-1).tolist():
        lo_, hi_ = int(out_offs[s] + total[s]), int(out_offs[s] + n[s])
        out[lo_:hi_] = sym_t[e0[s]]

    # streams with an nb == 0 step: the serial chain
    idx = torch.nonzero(stuck).reshape(-1)
    if idx.numel():
        sub = huf_pc.huf_pc_decode_plain(
            payload, starts[idx], lens[idx], bits0[idx], out_offs[idx],
            out_lens[idx], cells[idx], tlogs, tables, n_out)
        for j, s in enumerate(idx.tolist()):
            a_ = int(out_offs[s])
            out[a_ : a_ + int(out_lens[s])] = sub[0][a_ : a_ + int(out_lens[s])]
            bl[s] = int(sub[1][j])
        passes[idx] = -1
    return out, bl.to(torch.int32), passes.to(torch.int32)


def passes_summary(passes: Optional[torch.Tensor]) -> str:
    """'mean m, max M, k serial' of a per-stream sync-pass array."""
    if passes is None or passes.numel() == 0:
        return "no streams"
    p = passes.to(torch.int64)
    ok = p[p >= 0]
    mean = float(ok.double().mean()) if ok.numel() else 0.0
    top = int(ok.max()) if ok.numel() else 0
    return f"mean {mean:.3f}, max {top}, {int((p < 0).sum())} serial"
